"""Seeded random streams: one torch.Generator per (seed, purpose), so that
every input the benchmark draws comes from `--seed` (any whole number,
also beyond 32 bits) and two purposes never share a stream."""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for `purpose`, fixed by `seed`."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    """A torch.Generator on `device`, seeded for (seed, purpose)."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, purpose))
    return g
