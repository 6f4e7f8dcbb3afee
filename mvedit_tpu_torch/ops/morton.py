"""Morton (Z-order) encode / decode and occupancy-bitfield packing
(counterpart of `mvedit_tpu/ops/morton.py`).

The reference keeps its density grid in Morton order for warp locality
(`lib/ops/raymarching/src/raymarching.cu:214-302`); the port's grid is a
plain (G, G, G) array, so these ops serve interop with such grids and the
packed bitfield. torch's `uint32` lacks arithmetic kernels on many builds,
so the bit tricks run in int64 with every step masked to 32 bits, which is
the JAX package's uint32 arithmetic, wrap included.
"""
import torch

__all__ = ["morton3d", "morton3d_invert", "packbits"]

_M32 = 0xFFFFFFFF


def _expand_bits(v):
    v = ((v * 0x00010001) & _M32) & 0xFF0000FF
    v = ((v * 0x00000101) & _M32) & 0x0F00F00F
    v = ((v * 0x00000011) & _M32) & 0xC30C30C3
    v = ((v * 0x00000005) & _M32) & 0x49249249
    return v


def morton3d(coords):
    """coords: (..., 3) int in [0, 1024) -> (...) uint32 Morton codes."""
    c = torch.as_tensor(coords).to(torch.int64) & _M32
    code = (_expand_bits(c[..., 0]) | (_expand_bits(c[..., 1]) << 1)
            | (_expand_bits(c[..., 2]) << 2)) & _M32
    return code.to(torch.uint32)


def _compact_bits(v):
    v = v & 0x49249249
    v = (v ^ (v >> 2)) & 0xC30C30C3
    v = (v ^ (v >> 4)) & 0x0F00F00F
    v = (v ^ (v >> 8)) & 0xFF0000FF
    v = (v ^ (v >> 16)) & 0x0000FFFF
    return v


def morton3d_invert(codes):
    """(...,) uint32 Morton codes -> (..., 3) int32 coords."""
    c = torch.as_tensor(codes).to(torch.int64) & _M32
    return torch.stack([_compact_bits(c), _compact_bits(c >> 1),
                        _compact_bits(c >> 2)], -1).to(torch.int32)


def packbits(grid, thresh):
    """Flat density grid (N,) -> (N // 8,) uint8 bitfield; bit i of byte b
    is set when grid[8 * b + i] > thresh (the reference's kernel_packbits)."""
    bits = (grid.reshape(-1, 8) > thresh).to(torch.int64)
    shifts = torch.arange(8, device=bits.device)
    return (bits << shifts).sum(-1).to(torch.uint8)
