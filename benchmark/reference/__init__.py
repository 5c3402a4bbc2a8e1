"""The plain reference that decides `correct`: AES-128 (aes.py), the small
LWE secret key worked out again from the seed (secret_key.py) and the
decode of the compressed wire words (wire.py). Plain NumPy: it imports no
JAX and nothing of the port, and takes nothing the port made."""
