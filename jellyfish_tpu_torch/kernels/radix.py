"""Stable LSD radix sort of (int64 key, int64 payload) pairs: the
Bloom-counter insert's pair sort (bloom.BloomCounter2.insert_counts), the
counterpart of `lax.sort([pos, wb], num_keys=1)` in jellyfish_tpu/bloom.py.

`radix_sort_pairs` launches csrc/radix.cu on CUDA tensors and runs
`radix_sort_pairs_plain` on CPU tensors; any other device raises. Both sort
by the key's low `key_bits` bits, one DIGIT_BITS-bit digit a pass from the
lowest, each pass stable: the keys come out in ascending order, and equal
keys keep their input order, payloads with them. With key_bits < 64 the
caller guarantees 0 <= key < 2^key_bits; with key_bits = 64 the top digit's
sign bit is flipped, so any int64 sorts as a signed value.

On the card one call is 2 + ceil(key_bits / DIGIT_BITS) kernel launches
(the histogram of every pass, its scan, one kernel a pass);
`radix_sort_pairs.launches` counts calls.
"""

from __future__ import annotations

import ctypes

import torch

from jellyfish_tpu_torch.kernels import _build

__all__ = ["DIGIT_BITS", "radix_passes", "radix_sort_pairs",
           "radix_sort_pairs_plain"]

DIGIT_BITS = 8  # csrc/radix.cu's kBits
_SIGN = -(1 << 63)  # int64 bit pattern of 2^63

_P, _N, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "jf_radix_tile": (ctypes.c_int64, []),
    "jf_radix_sort": (ctypes.c_int, [_P, _P, _P, _P, _P, _P, _N, _I, _P, _P]),
}


def radix_passes(key_bits: int) -> int:
    return -(-key_bits // DIGIT_BITS)


def _checked(keys, payload, key_bits):
    """keys [M, 1] or [M] and payload [M] -> (keys [M], payload [M])."""
    if keys.dtype != torch.int64 or payload.dtype != torch.int64:
        raise ValueError("radix_sort_pairs takes int64 tensors")
    if keys.dim() == 2 and keys.shape[1] == 1:
        keys = keys[:, 0]
    if keys.dim() != 1 or payload.shape != keys.shape:
        raise ValueError("radix_sort_pairs takes keys [M, 1] or [M] and a "
                         "payload [M]")
    if not (keys.is_contiguous() and payload.is_contiguous()):
        raise ValueError("radix_sort_pairs takes contiguous tensors")
    if keys.device != payload.device:
        raise ValueError("radix_sort_pairs inputs lie on different devices")
    if not 1 <= key_bits <= 64:
        raise ValueError(f"radix_sort_pairs: key_bits {key_bits} not in "
                         "1..64")
    return keys, payload


def radix_sort_pairs_plain(keys, payload, key_bits: int):
    """The kernel's passes in plain torch: per digit from the lowest, the
    digit by shift and mask, a stable sort of it, a gather of keys and
    payload."""
    k, p = _checked(keys, payload, key_bits)
    u = k ^ _SIGN if key_bits == 64 else k
    for shift in range(0, key_bits, DIGIT_BITS):
        # >> is arithmetic on int64: keep the digit's bits below bit 64
        mask = (1 << min(DIGIT_BITS, 64 - shift)) - 1
        order = torch.sort((u >> shift) & mask, stable=True).indices
        u, p = u[order], p[order]
    k = u ^ _SIGN if key_bits == 64 else u
    return k[:, None], p


def radix_sort_pairs(keys, payload, key_bits: int):
    """(keys [M, 1] or [M], payload [M]) int64 -> (keys [M, 1], payload
    [M]) sorted stably by the key's low key_bits bits (1-64)."""
    k, p = _checked(keys, payload, key_bits)
    dev = k.device
    if dev.type == "cpu":
        return radix_sort_pairs_plain(k, p, key_bits)
    if dev.type != "cuda":
        raise ValueError(f"radix_sort_pairs: unsupported device {dev}")
    m = k.shape[0]
    if m == 0:
        return k.new_empty((0, 1)), p.new_empty(0)
    lib = _build.load("radix", _SIGNATURES)
    passes = radix_passes(key_bits)
    radix = 1 << DIGIT_BITS
    tiles = -(-m // lib.jf_radix_tile())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ka, pa = torch.empty_like(k), torch.empty_like(p)
        kb, pb = ((torch.empty_like(k), torch.empty_like(p)) if passes > 1
                  else (ka, pa))
        scratch = torch.empty(2 * passes * radix + 1 + tiles * radix,
                              dtype=torch.int64, device=dev)
        _build.check(
            lib.jf_radix_sort(k.data_ptr(), p.data_ptr(), ka.data_ptr(),
                              pa.data_ptr(), kb.data_ptr(), pb.data_ptr(), m,
                              key_bits, scratch.data_ptr(), stream),
            "radix_sort_pairs",
        )
    radix_sort_pairs.launches += 1
    k, p = (ka, pa) if passes % 2 else (kb, pb)
    return k[:, None], p


radix_sort_pairs.launches = 0
