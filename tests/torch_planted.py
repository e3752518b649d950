"""Planted contract violations for the op scan of ``repro_torch.analyze``,
shared by the CPU tests (``test_torch_analyze.py``) and the card check
(``chip_smoke.py``'s contract-checking path); the port only, no JAX.

:class:`Planted` wraps a plan and hides one violation in its slot
function: a host read (``.item()``), a data-dependent shape
(``nonzero``), a draw from PyTorch's generator (``torch.rand``), a
boolean-mask index, or a float64 op; each must be found exactly once,
under its own rule.
"""
import torch


def _item(payload, ok):
    return payload + int(payload.sum().item() * 0), ok


def _nonzero(payload, ok):
    return payload, ok & (ok.nonzero().shape[0] >= 0)


def _rand(payload, ok):
    return payload, ok & (torch.rand(ok.shape, device=ok.device) < 2)


def _bool_index(payload, ok):
    return payload, ok & (payload[ok].sum() >= 0)


def _f64(payload, ok):
    return payload, ok & (payload[..., 0].double() >= -1)


#: rule id -> the slot-function suffix that plants it
PLANTS = {"host-callback": _item, "dynamic-shape": _nonzero,
          "nondeterministic-rng": _rand, "dynamic-shape/bool-index": _bool_index,
          "f64-op": _f64}


class Planted:
    """A plan whose slot function ends in ``PLANTS[plant]``; its signature
    carries ``tag`` so that it has a cache entry of its own."""

    def __init__(self, inner, plant: str, tag: str = "planted"):
        self.inner, self.plant, self.tag = inner, plant, tag

    @property
    def num_pes(self):
        return self.inner.num_pes

    def input_arrays(self):
        return self.inner.input_arrays()

    def stream_index(self):
        return self.inner.stream_index()

    def signature(self):
        return (self.tag, self.plant) + self.inner.signature()

    def slot_fn(self):
        one, extra = self.inner.slot_fn(), PLANTS[self.plant]

        def bad(*rows):
            return extra(*one(*rows))

        return bad
