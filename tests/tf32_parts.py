"""TF32 rounding as the card's ``cvt.rna.tf32.f32`` does it, and the split
of a float32 into TF32 hi and lo parts, for the CPU emulations of the
float32 kernels that run three TF32 products on the tensor cores
(``csrc/tf32_wgmma.cuh``: the matmul walk, ``tests/test_torch_paco_
kernels.py``, and the flash pair's float32 family,
``tests/test_torch_flash_attention.py``, whose A fragments take the
conversion-free split ``tf32_split_fast`` and whose untransposed B
operands ``tf32_split_raw``)."""
import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest of 10 mantissa bits, ties away from zero, by int32 bit
    operations (half a TF32 step added to the bits, the low 13 cleared; a
    value past TF32's largest rounds to infinity), inf and nan unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & -0x2000
    return torch.where(torch.isfinite(x), rounded, bits).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo): x rounded to TF32, and the rest rounded to TF32."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_split_fast(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo) as ``split_tf32_fast`` leaves them to wgmma: hi
    rounded as ``tf32_round``, lo = x - hi with its low 13 bits dropped
    (wgmma reads the TF32 bits of an f32 register)."""
    hi = tf32_round(x)
    lo = (x - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def tf32_split_raw(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo) as ``lo_of_raw`` leaves them to wgmma: hi is x's own
    bits, which wgmma reads with the low 13 cleared (x truncated to TF32),
    and lo the rest rounded to TF32 (``tf32_round``)."""
    hi = (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
    return hi, tf32_round(x - hi)
