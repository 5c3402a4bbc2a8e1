"""FHE model layer."""
