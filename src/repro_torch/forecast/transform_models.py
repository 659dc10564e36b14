"""Data-transformation models (paper §3.1 'Data Transformation Models',
§4.1 Fig. 4): the SAME 4-function interface used for pure data processing —
here, integrating an irregular instantaneous current feed into a regular
15-minute energy series. To consumers the output is just another semantic
time-series."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.registry import ModelInterface
from ..timeseries.transforms import DAY, integrate_to_energy


class EnergyFromCurrentModel(ModelInterface):
    """score() reads CURRENT_MAG at the context entity, integrates to kWh on
    a regular grid, and the executor persists it as a forecast-series on the
    target context (signal ENERGY_LOAD_DERIVED)."""
    KIND = "XFORM"
    DEFAULTS = {"voltage": 230.0, "out_step": 900.0, "window_days": 7}

    def load(self):
        up = {**self.DEFAULTS, **self.user_params}
        now = float(up.get("now", 0.0))
        src_sig = up.get("source_signal", "CURRENT_MAG")
        ctx = self.system.graph.context(src_sig, self.context.entity.name)
        t0 = now - float(up["window_days"]) * DAY
        self._raw = self.system.store.read(ctx.ts_id, t0, now)
        self._up = up
        return self._raw

    def transform(self):
        t, i = self._raw
        grid, energy = integrate_to_energy(
            t, i, voltage=self._up["voltage"], step=self._up["out_step"])
        self._out = (grid, energy)
        return self._out

    def train(self):
        # transformation models are stateless; "training" records config only
        self.load()
        return {"kind": self.KIND, "config": dict(self._up)}

    def score(self, model_object) -> Tuple[np.ndarray, np.ndarray]:
        self.load()
        return self.transform()
