"""The traffic generator: a pure function of the seed, and every seed offers
the same work in another order."""

from __future__ import annotations

import json

import numpy as np
import pytest
from conftest import ROOT, load

from portbench.traffic import TrainData, length_quantiles, serve_requests

CLASSIFY = json.loads((ROOT / "portbench" / "traffic" / "classify-512-2048.json").read_text())
RUN = json.loads((ROOT / "portbench" / "configs" / "internvl2-26b.json").read_text())["run"]


def test_serving_requests_repeat_for_a_seed():
    a = serve_requests(CLASSIFY, RUN, 7.0, 40.0, 2**31 + 17)
    b = serve_requests(CLASSIFY, RUN, 7.0, 40.0, 2**31 + 17)
    assert [(r.due, r.prompt) for r in a] == [(r.due, r.prompt) for r in b]


def test_every_seed_offers_the_same_arrivals_and_lengths():
    runs = [serve_requests(CLASSIFY, RUN, 7.0, 40.0, seed) for seed in (1, 2, 2**31 + 5)]
    assert len({len(r) for r in runs}) == 1 and len(runs[0]) == 280
    lengths = [sorted(len(q.prompt) for q in r) for r in runs]
    assert lengths[0] == lengths[1] == lengths[2]
    assert lengths[0] == sorted(length_quantiles(CLASSIFY["text_len"], 280))
    assert min(lengths[0]) >= 512 and max(lengths[0]) <= 2048
    # one arrival schedule (the last request's gap runs to the window's end)
    gaps = [np.append(np.diff([q.due for q in r]), 40.0 - r[-1].due) for r in runs]
    assert np.array_equal(gaps[0], gaps[1]) and np.array_equal(gaps[0], gaps[2])
    assert gaps[0].sum() == pytest.approx(40.0) and len(set(gaps[0].round(9))) == 10
    assert [len(q.prompt) for q in runs[0]] != [len(q.prompt) for q in runs[1]]
    assert runs[0][0].prompt != runs[1][0].prompt


def test_no_block_of_arrivals_holds_more_than_its_share_of_long_prompts():
    for seed in (1, 2, 3):
        reqs = serve_requests(CLASSIFY, RUN, 7.0, 40.0, seed)
        k = CLASSIFY["block"]
        blocks = [sorted(len(q.prompt) for q in reqs[i:i + k]) for i in range(0, len(reqs), k)]
        longest = sorted(len(q.prompt) for q in reqs)[-len(blocks):]
        assert all(sum(n >= longest[0] for n in b) == 1 for b in blocks)


def test_training_batches_are_a_function_of_seed_and_step_with_distinct_rows():
    spec, run = load("tiny-train.json"), load("tiny-vlm.json")["run"]
    a, b = TrainData(spec, run, 9), TrainData(spec, run, 9)
    for step in range(4):
        x, y = a.next(), b.batch_at(step)
        assert all(np.array_equal(x[k], y[k]) for k in x)
        assert x["patch_embeds"].shape == (2, 8, 64)
        assert not np.array_equal(x["tokens"][0], x["tokens"][1])
        assert (x["targets"][:, :-1] == x["tokens"][:, 1:]).all()
        assert (x["targets"][:, -1] == -1).all()
    assert not np.array_equal(TrainData(spec, run, 10).batch_at(0)["tokens"], y["tokens"])


@pytest.mark.parametrize("name", ["tiny-train.json", "train-b4-s1024.json"])
def test_no_patch_vector_of_a_step_is_one_of_another_steps(name):
    """A model's patch embeddings repeated across the checked steps move the
    head's change after three steps in bf16 far past the f32 reference's
    (PERF.md, Open questions): every step's patch vectors are its own."""
    spec = load(name) if name.startswith("tiny") else json.loads(
        (ROOT / "portbench" / "traffic" / name).read_text())
    run = dict(load("tiny-vlm.json")["run"], d_model=64, n_vision_patches=8)
    data = TrainData(dict(spec, batch=2, text_len=8), run, 2**31 + 3)
    seen = set()
    for step in list(range(40)) + [1000, 6143]:
        x = data.batch_at(step)["patch_embeds"]
        assert np.shares_memory(x, data.patches) and x.flags.c_contiguous  # a view, no copy
        vectors = {v.tobytes() for v in x.reshape(-1, 64)}
        assert len(vectors) == 16 and not vectors & seen
        seen |= vectors
