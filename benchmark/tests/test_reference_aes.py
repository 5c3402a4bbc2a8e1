"""The reference's AES-128 against FIPS-197's own vectors, and its
partial AES (a CPU test's shorter runs) against the port's clear oracle."""

import pytest

from benchmark.reference import aes


@pytest.mark.parametrize("key,plain,cipher", [
    # FIPS-197 Appendix C.1
    ("000102030405060708090a0b0c0d0e0f", "00112233445566778899aabbccddeeff",
     "69c4e0d86a7b0430d8cdb78070b4c55a"),
    # FIPS-197 Appendix B
    ("2b7e151628aed2a6abf7158809cf4f3c", "3243f6a8885a308d313198a2e0370734",
     "3925841d02dc09fbdc118597196a0b32"),
])
def test_fips197_vectors(key, plain, cipher):
    got = aes.encrypt_blocks(bytes.fromhex(key), [bytes.fromhex(plain)])
    assert got == [bytes.fromhex(cipher)]


def test_sbox_and_last_round_key():
    # FIPS-197 Figure 7 and Appendix A.1 (w[40..43] of key 2b7e...)
    assert (aes.SBOX[0x00], aes.SBOX[0x53], aes.SBOX[0xFF]) == (0x63, 0xED,
                                                                 0x16)
    w = aes.expand_key(bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c"))
    assert bytes(sum(w[40:44], [])).hex() == \
        "d014f9a8c9ee2589e13f0cc8b6630ca6"


@pytest.mark.parametrize("rounds", range(1, 11))
def test_partial_rounds_are_the_reference_crates(rounds):
    """Rounds 1 .. r-1 in full, then the final round under round key 10:
    the port's aes_128/plain.py (the reference crate's plain.rs:75-103)."""
    from tfhe_aes2_tpu_torch.aes_128 import plain
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    blocks = [bytes.fromhex("3243f6a8885a308d313198a2e0370734"),
              bytes(range(16))]
    assert aes.encrypt_blocks(key, blocks, rounds) == \
        plain.expand_key_and_encrypt_blocks(key, blocks, rounds)
