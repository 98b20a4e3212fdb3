"""Counter-based threefry-2x32 RNG, bit for bit that of
``cpm_tpu/ops/rng.py`` and of the default ``jax.random`` key derivation.

Torch has no uint32 arithmetic with a logical right shift, so words are
held in int64 and masked to 32 bits after every add. The same code runs on
Python ints, which is how the host derives keys (:func:`prng_key`,
:func:`fold_in`).
"""

from __future__ import annotations

import torch

from cpmbench.reference.device import resolve

Tensor = torch.Tensor

MASK = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1, rounds: int = 20):
    """Threefry-2x32 block cipher: (counter words) -> (random words).

    Inputs are uint32 values held in Python ints or int64 tensors; they
    broadcast. 20 rounds matches Random123 and ``jax.random``.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for r in range(rounds):
        x0 = (x0 + x1) & MASK
        x1 = _rotl(x1, _ROT[r % 8]) ^ x0
        if (r + 1) % 4 == 0:
            g = (r + 1) // 4
            x0 = (x0 + ks[g % 3]) & MASK
            x1 = (x1 + ks[(g + 1) % 3] + g) & MASK
    return x0, x1


def bits_to_uniform(bits: Tensor) -> Tensor:
    """uint32 words (int64 tensor) -> float32 uniforms in [0, 1)."""
    f = (bits >> 9) | 0x3F800000
    return f.to(torch.int32).view(torch.float32) - 1.0


def uniforms(k0: int, k1: int, lane_ids: Tensor, step: int,
             n_draws: int) -> Tensor:
    """(N, n_draws) uniforms for wavefront ``step``: counter c0 = lane id,
    c1 = step * ceil(n/2) + pair index; each evaluation yields two draws.
    All pairs are hashed in one batched call."""
    pairs = (n_draws + 1) // 2
    lane = lane_ids.to(torch.int64)[:, None] & MASK
    base = (step * pairs) & MASK
    c1 = (base + torch.arange(pairs, dtype=torch.int64,
                              device=lane.device)) & MASK
    a, b = threefry2x32(k0, k1, lane, c1[None, :])
    u = torch.stack([bits_to_uniform(a), bits_to_uniform(b)], dim=-1)
    return u.reshape(lane.shape[0], 2 * pairs)[:, :n_draws]


def prng_key(seed: int) -> tuple[int, int]:
    """The key words of ``jax.random.PRNGKey(seed)`` (threefry, 32-bit
    seeds): (0, seed as uint32)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit in int32")
    return (0, seed & MASK)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """The key words of ``jax.random.fold_in(key, data)``: threefry of the
    counter pair (0, data as uint32) under ``key``."""
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data) & MASK)


# The two twins below follow jax.random's partitionable threefry scheme
# (``jax_threefry_partitionable``, the default since JAX 0.5): element i of
# a draw is keyed by the counter pair (i >> 32, i & MASK).

def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """The key words of ``jax.random.split(key, num)``: key i is threefry
    of the counter pair (0, i), that is ``fold_in(key, i)``."""
    return [fold_in(key, i) for i in range(num)]


def uniform(key: tuple[int, int], shape, device=None) -> Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)) bit for bit:
    the two words of threefry over (i >> 32, i & MASK) for flat index i,
    XORed, then :func:`bits_to_uniform`; on the card unless ``device``
    names another."""
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=resolve(device))
    a, b = threefry2x32(int(key[0]), int(key[1]), i >> 32, i & MASK)
    return bits_to_uniform(a ^ b).reshape(tuple(shape))
