"""The golden values that ``chip_smoke.py`` holds the card against.

``src/repro_torch/golden/er.json`` records, from the JAX package on the
CPU, SHA-256 digests of ``generate(spec, P).edges`` and the exact degree
statistics of one ``collect``.  The JAX package must still reproduce
every entry except the mid-size one (its command is in the file), and
the port on the CPU must reproduce the small ones.  Every comparison is
exact: digests and integers with ``==``.
"""
import json

import pytest
import torch

import torch_golden
from repro_torch import api as tapi

# one intra-op thread: the suite runs in several worker processes at once,
# and a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

DOC = json.loads(torch_golden.GOLDEN.read_text())
SMALL = [e for e in DOC["generate"] if e["size"] == "small"]


def _id(e):
    return f"{e['family']}-{'d' if e['params']['directed'] else 'u'}-P{e['P']}"


def test_the_file_names_its_command_and_entries():
    assert DOC["command"] == torch_golden.COMMAND
    assert [(e["family"], e["params"], e["P"]) for e in SMALL] == [
        (f, p, P) for f, p in torch_golden.SMALL for P in torch_golden.SMALL_PES]
    mid = [e for e in DOC["generate"] if e["size"] == "mid"]
    assert [(e["family"], e["params"]) for e in mid] == [torch_golden.MID]
    assert mid[0]["m"] == torch_golden.MID[1]["m"]


@pytest.mark.parametrize("entry", SMALL, ids=_id)
def test_reference_reproduces_generate_digest(entry):
    assert torch_golden.generate_entry(entry["family"], entry["params"], entry["P"],
                                       "small") == entry


@pytest.mark.parametrize("entry", SMALL, ids=_id)
def test_port_reproduces_generate_digest_on_cpu(entry):
    spec = getattr(tapi, entry["family"])(**entry["params"])
    edges = tapi.generate(spec, entry["P"], device="cpu").edges.numpy()
    assert len(edges) == entry["m"]
    assert torch_golden.edges_sha256(edges) == entry["sha256"]


def test_reference_reproduces_collect():
    (entry,) = DOC["collect"]
    assert torch_golden.collect_entry(entry["family"], entry["params"], entry["P"]) == entry
