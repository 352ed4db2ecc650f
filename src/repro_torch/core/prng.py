"""The threefry2x32 counter-based generator and the samplers of the ACS,
bit for bit as ``jax.random`` computes them.

The JAX reference draws every action of every episode from threefry
keys: run ``r`` of a cell is keyed by ``fold_in(PRNGKey(seed), r)``,
split once per step and three ways per step, with ``fold_in(key,
0x5EED)`` for the write span.  This module recomputes those draws in
PyTorch, batched over any leading dimensions of the key tensor, so the
port's ledgers equal the reference's on the port's own draws.

Keys are ``(..., 2)`` int64 tensors holding the two uint32 words of a
JAX key.  All arithmetic runs on int64 masked to 32 bits: PyTorch has
no shifts on ``uint32``.

``jax_threefry_partitionable`` changes how ``split`` and the raw bits
derive their counters.  Every function that depends on it takes
``partitionable`` explicitly.  ``True`` is the default of the installed
JAX; the committed golden ledgers were drawn with ``False``.
"""

from __future__ import annotations

import math

import torch

#: the mode of the reference's JAX as installed; the goldens need False
PARTITIONABLE_DEFAULT = True

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_I64 = torch.int64
#: float32 ``finfo.tiny``: the lower end of the Gumbel sampler's uniform
_TINY = 1.1754943508222875e-38


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on broadcast int64
    tensors of uint32 values: key words ``k1, k2``, counter words ``x1,
    x2``.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = (((x2 << r) | (x2 >> (32 - r))) & _MASK) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31), the int32
    seeds JAX takes without x64: the (2,) key ``[0, seed]``."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not in [0, 2**31)")
    return torch.tensor([0, seed], dtype=_I64, device=device)


def _words(keys: torch.Tensor, ndim: int):
    """The two key words of ``keys`` (..., 2), with ``ndim`` trailing
    axes of size 1 so they broadcast against counters of that rank."""
    shape = keys.shape[:-1] + (1,) * ndim
    return keys[..., 0].reshape(shape), keys[..., 1].reshape(shape)


def _hash_halves(keys: torch.Tensor, size: int) -> torch.Tensor:
    """JAX's ``threefry_2x32(key, iota(size))``: the counters are cut in
    two halves (padded with a 0 when ``size`` is odd), hashed as the
    cipher's two words, and the outputs joined again.  Returns
    (..., size)."""
    half = (size + 1) // 2
    counts = torch.arange(2 * half, dtype=_I64, device=keys.device)
    if size % 2:
        counts = torch.where(counts == size, 0, counts)
    k1, k2 = _words(keys, 1)
    o1, o2 = threefry2x32(k1, k2, counts[:half], counts[half:])
    return torch.cat([o1, o2], dim=-1)[..., :size]


def _iota_hash(keys: torch.Tensor, shape: tuple):
    """The partitionable counters: a 64-bit iota over ``shape`` as
    (hi, lo) words (hi is 0 below 2**32 elements), hashed.  Returns the
    two output words, each (..., *shape)."""
    size = math.prod(shape)
    if size >= 2 ** 32:
        raise NotImplementedError("more than 2**32 draws from one key")
    lo = torch.arange(size, dtype=_I64, device=keys.device).reshape(shape)
    k1, k2 = _words(keys, len(shape))
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def split(keys: torch.Tensor, num: int,
          partitionable: bool = PARTITIONABLE_DEFAULT) -> torch.Tensor:
    """``jax.random.split(key, num)`` for every key of ``keys`` (..., 2):
    returns (..., num, 2)."""
    if partitionable:
        b1, b2 = _iota_hash(keys, (num,))
        return torch.stack([b1, b2], dim=-1)
    bits = _hash_halves(keys, 2 * num)
    return bits.reshape(keys.shape[:-1] + (num, 2))


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for every key of ``keys``
    (..., 2); ``data`` is an int or an integer tensor that broadcasts
    against ``keys.shape[:-1]``.  The same in both modes."""
    if isinstance(data, int):   # a fill, not a copy from the host
        data = torch.full((), data, dtype=_I64, device=keys.device)
    data = torch.as_tensor(data, dtype=_I64, device=keys.device) & _MASK
    k1, k2 = keys[..., 0], keys[..., 1]
    o1, o2 = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def random_bits(keys: torch.Tensor, shape: tuple,
                partitionable: bool = PARTITIONABLE_DEFAULT
                ) -> torch.Tensor:
    """32 random bits per element: (..., *shape) int64 in [0, 2**32)."""
    shape = tuple(shape)
    if partitionable:
        b1, b2 = _iota_hash(keys, shape)
        return b1 ^ b2
    bits = _hash_halves(keys, math.prod(shape))
    return bits.reshape(keys.shape[:-1] + shape)


def uniform(keys: torch.Tensor, shape: tuple,
            partitionable: bool = PARTITIONABLE_DEFAULT) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [0, 1): the top 23 bits
    become the mantissa of a float in [1, 2), which then loses 1."""
    bits = random_bits(keys, shape, partitionable)
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return one_to_two.view(torch.float32) - 1.0


def bernoulli(keys: torch.Tensor, p, shape: tuple,
              partitionable: bool = PARTITIONABLE_DEFAULT) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in
    float32.  ``p`` is a float or a float32 tensor that broadcasts
    against (..., *shape)."""
    if isinstance(p, torch.Tensor):
        p = p.to(torch.float32)
    else:
        p = torch.full((), p, dtype=torch.float32, device=keys.device)
    return uniform(keys, shape, partitionable) < p


def randint(keys: torch.Tensor, shape: tuple, minval: int, maxval: int,
            partitionable: bool = PARTITIONABLE_DEFAULT) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds ``minval < maxval``: two
    32-bit draws per element reduced modulo the span.  Returns int64."""
    span = int(maxval) - int(minval)
    if span <= 0:
        raise ValueError("randint needs minval < maxval")
    halves = split(keys, 2, partitionable)
    hi = random_bits(halves[..., 0, :], shape, partitionable)
    lo = random_bits(halves[..., 1, :], shape, partitionable)
    multiplier = (2 ** 16 % span) ** 2 % span
    offset = ((hi % span) * multiplier + lo % span) & _MASK
    return int(minval) + offset % span


def gumbel(keys: torch.Tensor, shape: tuple,
           partitionable: bool = PARTITIONABLE_DEFAULT) -> torch.Tensor:
    """``jax.random.gumbel`` (low mode) in float32: ``-log(-log(u))``
    with ``u`` uniform on [tiny, 1)."""
    u = uniform(keys, shape, partitionable)
    tiny = torch.full((), _TINY, dtype=torch.float32, device=keys.device)
    # JAX's u * (maxval - minval) + minval: 1 - tiny rounds to 1 in f32
    u = torch.maximum(tiny, u + tiny)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor,
                shape: tuple | None = None,
                partitionable: bool = PARTITIONABLE_DEFAULT
                ) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` by Gumbel-max.
    ``shape`` is what one key draws, ``(*batch, k)``: the shape of one
    JAX call's ``logits`` (default ``logits.shape``).  ``logits`` itself
    broadcasts against (..., *shape), so it may carry one row per key.
    Returns the int64 argmax, (..., *batch)."""
    shape = tuple(logits.shape) if shape is None else tuple(shape)
    g = gumbel(keys, shape, partitionable)
    return torch.argmax(g + logits.to(torch.float32), dim=-1)
