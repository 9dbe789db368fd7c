"""The cell's weights, drawn on the device from the seed.

All normal leaves come from one bf16 buffer filled by a generator on the
device in a few large calls, then scaled leaf by leaf and cast to the dtype
each is served in; zeros and ones need no draw. The same seed on the same
device gives the same weights, so the reference draws them again after the
program has been freed rather than keeping a copy.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Tuple

import torch

CHUNK = 1 << 28          # elements a draw


def draw(leaves: List, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) for each ``Leaf`` of ``leaves``, in order."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(math.prod(leaf.shape) for leaf in leaves if leaf.init == "normal")
    flat = torch.empty(total, dtype=torch.bfloat16, device=device)
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    off = 0
    for leaf in leaves:
        dtype = getattr(torch, leaf.dtype)
        if leaf.init == "normal":
            n = math.prod(leaf.shape)
            t = (flat[off:off + n].view(leaf.shape) * leaf.std).to(dtype)
            off += n
        elif leaf.init == "zeros":
            t = torch.zeros(leaf.shape, dtype=dtype, device=device)
        elif leaf.init == "ones":
            t = torch.ones(leaf.shape, dtype=dtype, device=device)
        elif leaf.init == "linspace":
            t = torch.linspace(*leaf.span, math.prod(leaf.shape), dtype=torch.float32,
                               device=device).view(leaf.shape).to(dtype)
        else:
            raise ValueError(f"{leaf.name}: unknown init {leaf.init!r}")
        yield leaf.name, t
