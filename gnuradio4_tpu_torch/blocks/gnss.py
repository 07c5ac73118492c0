"""GNSS acquisition block (ops/gnss.py GPS L1 C/A search as a sink).

The Doppler × code-phase search itself runs on the device (one batched FFT
program per PRN, see ops.gnss.acquire_metric); this sink accumulates IQ
until it holds enough 1 ms code periods, runs the search for every PRN in
``prns``, and records the detections. The IQ is never copied to the host
(``WANTS_HOST_DATA = False``): it is gathered and searched on the graph's
device, and each PRN's search reads back its peak's four numbers.
"""

from __future__ import annotations

import torch

from ..core.block import Port, SinkBlock
from ..core.registry import register_block
from ..core.settings import Setting


@register_block("GnssAcquisition")
class GnssAcquisition(SinkBlock):
    """GPS C/A acquisition sink: ``detections`` = [{prn, doppler,
    code_phase, metric}, …] for every configured PRN that crosses the
    detection threshold."""

    IN = (Port("in", dtype="complex64"),)
    WANTS_HOST_DATA = False
    prns = Setting(default=tuple(range(1, 33)), kind="static")
    sample_rate_in = Setting(default=2.046e6, kind="static", unit="Hz")
    doppler_max = Setting(default=5000.0, kind="static", unit="Hz")
    doppler_step = Setting(default=250.0, kind="static", unit="Hz")
    n_coherent = Setting(default=2, kind="static", limits=(1, 64),
                         description="1 ms blocks summed non-coherently")
    threshold = Setting(default=2.5, kind="static")

    def __init__(self, name=None, **settings):
        super().__init__(name=name, **settings)
        self._iq: list[torch.Tensor] = []
        self._have = 0
        self.detections: list[dict] = []
        self._done = False

    def consume(self, arrays, tags, n_valid, abs_index):
        if self._done or n_valid <= 0:
            return
        x = torch.as_tensor(arrays["in"])[..., :n_valid].reshape(-1)
        self._iq.append(x)
        self._have += x.shape[0]
        need = int(round(float(self.settings.get("sample_rate_in")) * 1e-3)) \
            * int(self.settings.get("n_coherent"))
        if self._have >= need:
            self._run(torch.cat(self._iq)[:need])
            self._done = True
            self._iq.clear()

    def stop(self):
        if not self._done and self._iq:
            self._run(torch.cat(self._iq))
            self._done = True

    def _run(self, iq: torch.Tensor) -> None:
        from ..ops import gnss
        fs = float(self.settings.get("sample_rate_in"))
        n_ms = int(iq.shape[0] / (fs * 1e-3))
        if n_ms < 1:
            return          # less than one code period delivered — no search
        n_coh = min(int(self.settings.get("n_coherent")), n_ms)
        for prn in self.settings.get("prns"):
            r = gnss.acquire(
                iq, int(prn), fs=fs,
                doppler_max=float(self.settings.get("doppler_max")),
                doppler_step=float(self.settings.get("doppler_step")),
                n_coherent=n_coh,
                threshold=float(self.settings.get("threshold")),
                device=iq.device)
            if r is not None:
                self.detections.append(r)
