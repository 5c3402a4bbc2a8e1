"""L0 TFHE primitives on int64 torus tensors."""
