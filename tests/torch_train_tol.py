"""The tolerances of a train step held against another, shared by the CPU
tests (the port against the JAX package, ``tests/test_torch_train.py``),
the card tests and ``chip_smoke.py`` (the card against the CPU, and at
full width ``accum=2`` against ``accum=1``).

A step moves each master by up to about the learning rate: Adam's update
``m / (sqrt(v) + eps)`` is near +-1.  Where ``|g|`` is near ``eps``
(1e-8), that normalization turns a gradient's rounding into a share of
the update (its slope is up to 1/eps), so the masters are held to a
quarter of the step's learning rate: a wrong update (sign, bias
correction, learning rate) moves them by the whole of it.  ``m`` is
linear in the gradients, each taken at masters that already differ a
little after the first step: it is held to 5e-4 of each leaf's max (one
gradient's own bound is 5e-5, ``tests/test_torch_train.py``); a wrong
gradient moves it by a percent or more.
Seen, float32: between the packages on the CPU, three steps of the ten
smoke configs with ``accum`` 1 and 2: the loss 9.5e-7, the grad norm
1.7e-7 of it, the masters 2.3e-2 of the learning rate (qwen2_vl), ``m``
5.7e-5 of its leaf's max (jamba's ``conv_w`` at the third step); card
against CPU (NVIDIA H100 80GB HBM3, 700 W), the ten with ``accum`` 1 then
2: the masters 9.8e-2 of the learning rate and ``m`` 1.25e-4 (both
qwen2_vl); Qwen3-0.6B at full width, ``accum=2`` against ``accum=1`` on
the card: the masters 8.1e-2 of the learning rate (1.628e-5 at 2e-4).
"""
LOSS_ABS = 1e-5
GRAD_NORM_REL = 1e-6
PARAM_LR = 0.25
MOMENT_REL = 5e-4


def step_errors(got_params, got_m, got_metrics, want_params, want_m, want_metrics) -> dict:
    """The step's errors, each as a share of its bound, asserted to be
    at most 1: ``{"loss", "grad_norm", "params", "m"}`` (the worst leaf
    of the last two).  The ``params`` and ``m`` arguments are ``{name:
    tensor}`` (any devices); the metrics hold ``loss``, ``grad_norm`` and
    ``lr``."""
    lr = float(want_metrics["lr"])
    assert float(got_metrics["lr"]) == lr, (float(got_metrics["lr"]), lr)
    gn = float(want_metrics["grad_norm"])
    out = {"loss": abs(float(got_metrics["loss"]) - float(want_metrics["loss"])) / LOSS_ABS,
           "grad_norm": abs(float(got_metrics["grad_norm"]) - gn) / (GRAD_NORM_REL * gn)}
    worst = {}
    for what, got, want, bound in (("params", got_params, want_params, lambda w: PARAM_LR * lr),
                                   ("m", got_m, want_m,
                                    lambda w: MOMENT_REL * float(w.abs().max()))):
        assert set(got) == set(want), what
        out[what], worst[what] = 0.0, None
        for k, w in want.items():
            w = w.detach().cpu()
            err = float((got[k].detach().cpu() - w).abs().max())
            b = bound(w)
            share = err / b if b else (0.0 if err == 0 else float("inf"))
            if share > out[what]:
                out[what], worst[what] = share, k
    assert max(out.values()) <= 1, f"errors as shares of their bounds {out}, worst leaves {worst}"
    return out
