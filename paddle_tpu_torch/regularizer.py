"""``L1Decay`` / ``L2Decay`` — counterpart of ``paddle_tpu/regularizer.py``
(l.17-40).

The optimizers read the coefficient off these objects
(``optimizer.Optimizer._parse_wd``). Every optimizer here applies it as
L2-style decay (coupled into the gradient, or decoupled for ``AdamW``),
as the reference's do; for a true L1 penalty add ``coeff * sum(|w|)``
to the loss.
"""

from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    """Weight decay ``coeff * w``."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)
        self._regularization_coeff = float(coeff)

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"


class L1Decay:
    """L1 regularization ``coeff * sign(w)``, kept for the API: the
    optimizers decay L2-style when handed one (module docstring)."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)
        self._regularization_coeff = float(coeff)

    def __repr__(self):
        return f"L1Decay(coeff={self.coeff})"
