"""``repro_torch.train.serve`` against ``repro.train.serve``: greedy
``generate`` at qwen3-0.6b's smoke config on the reference's weights
(``repro_torch.models.convert``) gives the reference's tokens exactly,
on prompts from the data pipeline.

Greedy tokens are exact only where no step is a near-tie: the port's
logits are within 1e-5 x max |logit| of the reference's
(``tests/test_torch_models.py``), so every step's top-2 gap must exceed
``GAP`` = 1e-4 x max |logit|, ten times that tolerance, or an argmax
could flip with neither package at fault.  The test asserts the gap,
so a near-tie cannot pass or fail silently.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jconfig
from repro.models import transformer as JT
from repro.train import serve as JS
from repro_torch.configs import get_smoke_config as tconfig
from repro_torch.data import pipeline as TD
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.train import serve as TS

torch.set_num_threads(1)

GAP = 1e-4      # of the step's max |logit|


def _setup(seed):
    jc, tc = jconfig("qwen3_0p6b"), tconfig("qwen3_0p6b")
    jp = JT.model_init(jax.random.key(seed), jc)
    return jc, tc, jp, convert.from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")


def _gaps(tp, tc, prompts, steps):
    """The top-2 gap over max |logit| of each of ``generate``'s steps,
    recomputed through ``prefill`` and ``decode_step``."""
    B, S = prompts.shape
    with torch.inference_mode():
        caches, logits = TS.prefill(tp, tc, torch.from_numpy(prompts), S + steps)
        out = []
        for t in range(steps):
            top = torch.topk(logits.float(), 2, dim=-1).values
            out.append(((top[:, 0] - top[:, 1]) / logits.abs().amax(dim=-1)).numpy())
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            pos = torch.full((B, 1), S + t, dtype=torch.int32)
            lg, caches = TT.decode_step(tp, tc, tok, pos, caches)
            logits = lg[:, -1]
    return np.stack(out, axis=1)


@pytest.mark.parametrize("seed,steps", [(0, 12), (7, 20)])
def test_generate_gives_the_reference_tokens(seed, steps):
    jc, tc, jp, tp = _setup(seed)
    dc = TD.DataConfig(vocab=tc.vocab, seq_len=32, batch_per_shard=4, seed=3 + seed)
    prompts = TD.make_batch(dc, 0, 0, device="cpu")["tokens"]
    want = JS.generate(jp, jc, prompts, steps)
    got = TS.generate(tp, tc, prompts, steps)
    assert got.shape == (4, steps) and got.dtype == np.int32
    gaps = _gaps(tp, tc, prompts, steps)
    assert gaps.min() > GAP, f"a near-tie: top-2 gap {gaps.min()} of max |logit|"
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got < tc.vocab).all()


def test_prefill_fills_the_caches_and_matches_the_reference_logits():
    jc, tc, jp, tp = _setup(1)
    prompts = np.random.default_rng(1).integers(0, tc.vocab, (2, 9)).astype(np.int32)
    jcaches, jlogits = JS.prefill(jp, jc, jax.numpy.asarray(prompts), 16)
    caches, logits = TS.prefill(tp, tc, torch.from_numpy(prompts), 16)
    assert [c["idx"] for c in caches] == [9] * tc.n_layers
    assert caches[0]["k"].shape == (2, 16, tc.n_kv_heads, tc.hd)
    want = np.asarray(jlogits)
    assert float(np.abs(logits.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max())
    # the cache rows past the prompt are still zero
    assert float(caches[0]["k"][:, 9:].abs().max()) == 0.0
    np.testing.assert_allclose(caches[0]["k"][:, :9].numpy(),
                               np.asarray(jcaches["body"][0]["k"][0][:, :9]), rtol=0, atol=1e-5)
