"""Gradient clipping — counterpart of ``paddle_tpu/optimizer/clip.py``
(l.16-79).

A clip object maps a list of ``(param, grad)`` pairs to a new one (the
optimizer calls it on the pairs of its step). A pair whose gradient is
``None``, or whose parameter has ``need_clip = False`` (an attribute a
caller may set; ``True`` when absent), passes through unchanged. Norms
are fp32; a clipped gradient is the fp32 product cast back to the
gradient's dtype. The global norm's scale stays a device scalar: a clip
never reads the card from the host.
"""

from __future__ import annotations

import torch


def _need_clip(p) -> bool:
    return getattr(p, "need_clip", True)


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as a true division (a Python float over a tensor is
    a reciprocal product in torch, an ulp off the reference's quotient)."""
    return den.new_full((), num) / den


class ClipGradBase:
    def _clip(self, params_grads):
        raise NotImplementedError

    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    """Each element clamped to ``[min, max]`` (``min`` defaults to
    ``-max``), in the gradient's dtype."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    def _clip(self, params_grads):
        return [(p, g) if g is None or not _need_clip(p)
                else (p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / max(|g|, 1e-12), 1)``,
    its own fp32 L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None or not _need_clip(p):
                out.append((p, g))
                continue
            g32 = g.float()
            norm = torch.sqrt(torch.sum(g32 * g32))
            scale = torch.clamp(
                _div(self.clip_norm, torch.clamp(norm, min=1e-12)), max=1.0)
            out.append((p, (g32 * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient scaled by ``clip_norm / max(gnorm,
    clip_norm)``, ``gnorm`` the fp32 L2 norm over all of them
    (``torch._foreach_norm``: one multi-tensor pass). The reference sums
    each gradient's squares in a plain reduction, so the norm agrees to
    fp32 summation order."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm

    @staticmethod
    def global_norm(grads) -> torch.Tensor:
        """The fp32 L2 norm over a list of gradients (``None`` skipped),
        a 0-d tensor on their device."""
        grads = [g for g in grads if g is not None]
        if not grads:
            return torch.zeros((), dtype=torch.float32)
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))

    def _clip(self, params_grads):
        idx = [i for i, (p, g) in enumerate(params_grads)
               if g is not None and _need_clip(p)]
        out = list(params_grads)
        if not idx:
            return out
        grads = [params_grads[i][1] for i in idx]
        gnorm = self.global_norm(grads)
        scale = _div(self.clip_norm, torch.clamp(gnorm, min=self.clip_norm))
        # (g.float() * scale).to(g.dtype), the products in one
        # multi-tensor pass
        prods = torch._foreach_mul([g.float() for g in grads], scale)
        for i, g, q in zip(idx, grads, prods):
            out[i] = (params_grads[i][0], q.to(g.dtype))
        return out
