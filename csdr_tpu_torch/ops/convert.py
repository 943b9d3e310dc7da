"""Sample-format converters (counterpart of csdr_tpu.ops.convert; reference
libcsdr.c:2363-2437, csdr.c:534-633).

All converters map to and from float32 in [-1, 1] with the reference's
scale constants (u8 biased by 128, s16 scaled by SHRT_MAX, s24 packed LE or
BE).  Complex streams are interleaved I, Q on the wire: the byte-domain
functions take the interleaved view and the ``*_c`` helpers pair it into
complex64.  Plain torch on the tensor's device, bit for bit csdr_tpu's.

Float to integer casts: csdr_tpu casts through XLA, whose f32 -> int32
conversion truncates toward zero and *saturates* (+-inf and values out of
range go to INT_MAX or INT_MIN, NaN to 0).  A torch cast leaves those cases
undefined (the CPU gives INT_MIN for all of them, the card saturates), so
:func:`f32_to_i32` clamps and sends NaN to 0 before it casts.  The narrow
types then wrap from int32 as csdr_tpu's ``astype`` chain does.
"""

from __future__ import annotations

import torch

UCHAR_MAX = 255
SCHAR_MAX = 127
SHRT_MAX = 32767
INT_MAX = 2147483647


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 -> int32 conversion: toward zero, saturating, NaN -> 0.
    The clamp runs in float64, where INT_MIN and INT_MAX are exact."""
    v = torch.nan_to_num(x.double(), nan=0.0)
    return v.clamp(-2.0 ** 31, INT_MAX).to(torch.int32)


def f32_to_i16_saturating(x: torch.Tensor) -> torch.Tensor:
    """XLA's *direct* float32 -> int16 conversion: toward zero, saturating
    at -32768 and 32767, NaN -> 0."""
    return torch.nan_to_num(x, nan=0.0).clamp(-32768.0, 32767.0).to(
        torch.int16)


def _wrap(v: torch.Tensor, bits: int, signed: bool, dtype) -> torch.Tensor:
    """The low ``bits`` of int32 ``v`` as ``dtype`` (two's complement wrap,
    as XLA's int32 -> narrow conversion)."""
    mask = (1 << bits) - 1
    low = v & mask
    if signed:
        half = 1 << (bits - 1)
        low = (low ^ half) - half
    return low.to(dtype)


def convert_u8_f(x: torch.Tensor) -> torch.Tensor:
    """u8 -> f32: x/127.5 - 1 (reference libcsdr.c:2365-2368)."""
    return x.to(torch.float32) / (UCHAR_MAX / 2.0) - 1.0


def convert_s8_f(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) / SCHAR_MAX


def convert_s16_f(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) / SHRT_MAX


def convert_f_u8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> u8: x*127.5 + 128 through int32, then the low byte, with no
    clipping first (reference libcsdr.c:2387-2392)."""
    return _wrap(f32_to_i32(x * (UCHAR_MAX * 0.5) + 128), 8, False,
                 torch.uint8)


def convert_f_s8(x: torch.Tensor) -> torch.Tensor:
    return _wrap(f32_to_i32(x * SCHAR_MAX), 8, True, torch.int8)


def convert_f_s16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> s16, toward zero with no clipping: out-of-range samples wrap
    through the int32 hop like the C store (reference libcsdr.c:2399-2407)."""
    return _wrap(f32_to_i32(x * SHRT_MAX), 16, True, torch.int16)


def convert_s24_f(b: torch.Tensor, bigendian: bool = False) -> torch.Tensor:
    """Packed 24-bit (uint8, length 3n) -> f32 (reference
    libcsdr.c:2427-2441): the word in the top three bytes of an int32,
    divided by INT_MAX - 256 (2147483392 as a float32)."""
    b = b.reshape(-1, 3).to(torch.int64)
    if bigendian:
        temp = (b[:, 2] << 24) | (b[:, 1] << 16) | (b[:, 0] << 8)
    else:
        temp = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8)
    temp = torch.where(temp >= 2 ** 31, temp - 2 ** 32, temp)
    return temp.to(torch.int32).to(torch.float32) / float(INT_MAX - 256)


def convert_f_s24(x: torch.Tensor, bigendian: bool = False) -> torch.Tensor:
    """f32 -> packed 24-bit (reference libcsdr.c:2409-2425), in csdr_tpu's
    byte order for each flag."""
    temp = f32_to_i32(x * (INT_MAX >> 8))
    b0, b1, b2 = (_wrap(temp >> s, 8, False, torch.uint8)
                  for s in (0, 8, 16))
    parts = [b0, b1, b2] if bigendian else [b2, b1, b0]
    return torch.stack(parts, dim=-1).reshape(-1)


def interleaved_to_cf(x: torch.Tensor) -> torch.Tensor:
    """float32 interleaved I, Q -> complex64 (reference libcsdr.h:46-66).
    A view of ``x`` where it is contiguous float32."""
    return torch.view_as_complex(
        x.to(torch.float32).reshape(-1, 2).contiguous())


def cf_to_interleaved(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x.to(torch.complex64)).reshape(-1)


def convert_u8_c(b: torch.Tensor) -> torch.Tensor:
    """Interleaved u8 I/Q bytes -> complex64 (rtl_sdr's wire format)."""
    return interleaved_to_cf(convert_u8_f(b))


def convert_s16_c(b: torch.Tensor) -> torch.Tensor:
    return interleaved_to_cf(convert_s16_f(b))


def mono2stereo_s16(x: torch.Tensor) -> torch.Tensor:
    """Each s16 sample twice (reference csdr.c mono2stereo_i16)."""
    return torch.repeat_interleave(x, 2)


def stereo2mono_s16(x: torch.Tensor) -> torch.Tensor:
    """L/R pairs to mono, floor((l + r) / 2) in int32.  csdr_tpu's
    extension: the reference has only mono2stereo_s16
    (csdr.c:2174-2189)."""
    x = x.reshape(-1, 2).to(torch.int32)
    return torch.div(x[:, 0] + x[:, 1], 2, rounding_mode="floor").to(
        torch.int16)
