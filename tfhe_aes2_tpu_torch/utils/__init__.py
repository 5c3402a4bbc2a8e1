from tfhe_aes2_tpu_torch.utils.bits import (
    bits_to_bytes,
    bits_to_u64,
    bits_to_u8,
    bytes_to_bits,
    u16_to_bits,
    u64_to_bits,
    u8_to_bits,
)
