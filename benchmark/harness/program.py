"""The system under test: the port's timed entry.

One batch is ``physics.simulate_batch`` (the pilot pattern, the Jakes
gains, the frequency response and the received grid), then
``estimators.estimate_batch`` (``ls``, ``mmse_full``, ... and under them
the ``ops`` kernels), then ``utils.metrics.nmse``, the batch's score.
This module is the only one of the benchmark that imports the port.
"""
from __future__ import annotations

from typing import Dict

import torch

from ce5g_torch.config import ChannelConfig, ExperimentConfig, MIMOConfig, OFDMConfig, PilotConfig
from ce5g_torch.estimators.api import estimate_batch
from ce5g_torch.physics import PROFILE_INDEX, FrameDraws, FrameParams, simulate_batch, table_for
from ce5g_torch.utils.metrics import nmse

from benchmark.reference.pipeline import BatchParams


def experiment_config(config: Dict) -> ExperimentConfig:
    """The port's configuration of a configuration file."""
    return ExperimentConfig(
        ofdm=OFDMConfig(fft_size=config["fft_size"], cp_length=config["cp_length"],
                        num_symbols=config["num_symbols"],
                        useful_subcarriers=config["useful_subcarriers"],
                        subcarrier_spacing=float(config["subcarrier_spacing"])),
        mimo=MIMOConfig(num_tx=config["num_tx"], num_rx=config["num_rx"]),
        channel=ChannelConfig(doppler_hz=tuple(float(d) for d in config["doppler_hz_configured"]),
                              carrier_freq=float(config["carrier_freq"]),
                              num_oscillators=config["num_oscillators"],
                              tap_collision=config["tap_collision"]),
        pilots=PilotConfig(pattern=config["pilot_pattern"], max_density=config["max_density"]),
    )


class Program:
    """The port configured for one cell."""

    def __init__(self, config: Dict, traffic: Dict, device):
        self.cfg = experiment_config(config)
        self.table = table_for(self.cfg)
        self.estimator = traffic["estimator"]
        self.method = traffic["method"]
        self.device = torch.device(device)
        self._index = {}
        self._last = (None, None)

    def frame_params(self, params: BatchParams) -> FrameParams:
        """The port's parameters of ``params`` (the last ones kept, so that
        a constant mix adds no work a batch)."""
        if self._last[0] is params:
            return self._last[1]
        key = params.profiles
        if key not in self._index:
            self._index[key] = torch.tensor([PROFILE_INDEX[p] for p in key], dtype=torch.int32,
                                            device=self.device)
        out = FrameParams(self._index[key][params.profile], params.doppler_hz, params.snr_db,
                          params.density)
        self._last = (params, out)
        return out

    def simulate(self, draws, params: FrameParams):
        return simulate_batch(FrameDraws(*draws), params, cfg=self.cfg, table=self.table,
                              device=self.device)

    def estimate(self, frames):
        return estimate_batch(frames, cfg=self.cfg, estimator=self.estimator, method=self.method,
                              table=self.table, device=self.device)

    def score(self, frames, h):
        return nmse(frames.channel, h)
