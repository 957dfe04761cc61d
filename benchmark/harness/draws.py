"""The inputs of each batch, made on the card from the seed and the batch
index, by the benchmark's own code so that their cost is the same on
every commit.

Batch i draws from a generator seeded with ``batch_seed(seed, i)``, so
that the check can make batch i's inputs again once the window has
closed. The laws are those of the port's ``physics.draw_frames``: pilot
uniforms U(0, 1) (B, S·K); TX phases 2π·U (B, S, 1, K), one grid for
every TX antenna; Jakes angles and phases 2π·U (B, P, R, T, O) over the 9
paths of the longest profile; noise N(0, 1) (B, S, R, K), real parts then
imaginary parts.

The per-frame parameters come from the traffic file: a field is a
number (every frame), a list (each frame draws one of its entries
uniformly) or {"uniform": [lo, hi]}. Fields that vary are drawn before
the frames' draws, from the same generator.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.carrier import MAX_PATHS, Carrier
from benchmark.reference.pipeline import BatchParams

_MIX = 0x9E3779B97F4A7C15
_FIELDS = ("doppler_hz", "snr_db", "pilot_density")


def batch_seed(seed: int, index: int) -> int:
    """The generator seed of batch ``index`` of a run seeded ``seed``."""
    return (seed * _MIX + index) % (1 << 63)


def _varies(value) -> bool:
    return isinstance(value, (list, dict))


class Inputs:
    """Maker of the batches' draws and parameters for one run."""

    def __init__(self, seed: int, batch: int, carrier: Carrier, traffic: Dict, device):
        self.seed = seed
        self.batch = batch
        self.carrier = carrier
        self.traffic = traffic
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        prof = traffic["profile"]
        self.profiles: Tuple[str, ...] = tuple(prof) if isinstance(prof, list) else (prof,)
        full = lambda v: torch.full((batch,), float(v), device=self.device)  # noqa: E731
        self.fixed = {f: full(traffic[f]) for f in _FIELDS if not _varies(traffic[f])}
        self.fixed_profile = torch.zeros(batch, dtype=torch.int64, device=self.device)
        self.constant = None
        if len(self.profiles) == 1 and len(self.fixed) == len(_FIELDS):
            self.constant = BatchParams(self.fixed_profile, self.fixed["doppler_hz"],
                                        self.fixed["snr_db"], self.fixed["pilot_density"],
                                        self.profiles)

    def params(self) -> BatchParams:
        """This batch's per-frame parameters (draws from the generator only
        for the fields that vary)."""
        if self.constant is not None:
            return self.constant
        b, gen = self.batch, self.gen
        profile = self.fixed_profile
        if len(self.profiles) > 1:
            profile = torch.randint(len(self.profiles), (b,), generator=gen, device=self.device)
        out = {}
        for f in _FIELDS:
            v = self.traffic[f]
            if f in self.fixed:
                out[f] = self.fixed[f]
            elif isinstance(v, list):
                table = torch.tensor(v, dtype=torch.float32, device=self.device)
                out[f] = table[torch.randint(len(v), (b,), generator=gen, device=self.device)]
            else:
                lo, hi = v["uniform"]
                u = torch.rand(b, generator=gen, device=self.device)
                out[f] = lo + (hi - lo) * u
        return BatchParams(profile, out["doppler_hz"], out["snr_db"], out["pilot_density"],
                           self.profiles)

    def __call__(self, index: int):
        """(draws, params) of batch ``index``."""
        c, b, dev, gen = self.carrier, self.batch, self.device, self.gen
        gen.manual_seed(batch_seed(self.seed, index))
        params = self.params()
        s, k, r, t = c.num_symbols, c.num_subcarriers, c.num_rx, c.num_tx
        two_pi = 2.0 * math.pi

        def uniform(*shape):
            return torch.rand(shape, generator=gen, device=dev)

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        jakes = (b, MAX_PATHS, r, t, c.num_oscillators)
        draws = (uniform(b, s * k), two_pi * uniform(b, s, 1, k), two_pi * uniform(*jakes),
                 two_pi * uniform(*jakes), normal(b, s, r, k), normal(b, s, r, k))
        return draws, params
