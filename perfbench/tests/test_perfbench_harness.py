"""The harness driven on the CPU past its look for a card, in the
miniature checkout: a sound run is correct, and each fault that a serving
cell can have, planted under the timed path, makes ``correct`` false.
The control (the reference in float8) fails the limits too."""
import json
import time

import numpy as np
import pytest
import torch

from conftest import TINY, TINY_TRAFFIC, make_root
from benchlib import check, runner
from reference import lm as ref

CPU = torch.device("cpu")
CELLS = [f"{m}.{t}" for m in sorted(TINY) for t in sorted(TINY_TRAFFIC)]
SEED = 2**31 + 101


@pytest.fixture
def root32(tmp_path):
    """The miniature checkout with float32 configurations: the sound
    program then matches the reference to rounding."""
    return make_root(tmp_path, "float32")


def _run(root, cell, seconds=1.0, trace=False, seed=SEED):
    torch.manual_seed(0)
    res = runner.run_cell(cell, seed, seconds, trace, dev=CPU,
                          t_process=time.perf_counter(), root=root)
    res.pop("extra")
    json.dumps(res)          # the result line is JSON
    return res


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root32, cell):
    res = _run(root32, cell)
    assert res["correct"], res["check"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "check"
    want = {"setup_s"} | ({"prefill_tok_s", "ttft_ms.p90"}
                          if "prefill" in cell else {"output_tok_s"})
    assert set(res["metrics"]) == want


def _altered_token(monkeypatch):
    """Row 0's sampler off by one: every token it produces is the next id
    (fed back as the program would)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm
    orig_prefill, orig_step = lm.prefill, lm.decode_step

    def off_by_one(logits):
        logits = logits.clone()
        best = logits[0, -1].argmax()
        logits[0, -1, (best + 1) % logits.shape[-1]] = logits[0, -1].max() + 1
        return logits

    def prefill(params, cfg, tokens, ctx=None):
        logits, caches = orig_prefill(params, cfg, tokens, ctx)
        return off_by_one(logits), caches

    def decode_step(params, cfg, token, caches, pos, ctx=None):
        logits, caches = orig_step(params, cfg, token, caches, pos, ctx)
        return off_by_one(logits), caches
    monkeypatch.setattr(lm, "prefill", prefill)
    monkeypatch.setattr(lm, "decode_step", decode_step)
    assert serve.lm is lm


def _state_unchanged(monkeypatch):
    from repro_torch.models import lm
    orig = lm.decode_step

    def decode_step(params, cfg, token, caches, pos, ctx=None):
        logits, _ = orig(params, cfg, token, caches, pos, ctx)
        return logits, caches
    monkeypatch.setattr(lm, "decode_step", decode_step)


def _half_batch(monkeypatch):
    from repro_torch.launch import serve
    orig = serve.generate

    def generate(params, cfg, prompts, gen_tokens, ctx=None):
        B = prompts.shape[0]
        g = orig(params, cfg, prompts[:max(1, B // 2)], gen_tokens, ctx)
        reps = -(-B // g.tokens.shape[0])
        g.tokens = np.concatenate([g.tokens] * reps)[:B]
        g.prefill_logits = torch.cat([g.prefill_logits] * reps)[:B]
        return g
    monkeypatch.setattr(serve, "generate", generate)


def _altered_answer(monkeypatch):
    """Row 0's prompt logits shifted by one token id where the head makes
    them (``lm.forward`` in the prefill), so its answer is another."""
    from repro_torch.models import lm
    orig = lm.forward

    def forward(*args, **kwargs):
        out = orig(*args, **kwargs)
        if not kwargs.get("collect_caches"):
            return out
        logits = out[0].clone()
        logits[0] = torch.roll(logits[0], 1, dims=-1)
        return (logits,) + tuple(out[1:])
    monkeypatch.setattr(lm, "forward", forward)


FAULTS = {"altered_answer": _altered_answer,
          "altered_token": _altered_token,
          "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_incorrect(root32, monkeypatch, cell, fault):
    prefill_only = TINY_TRAFFIC[cell.split(".", 1)[1]]["gen_tokens"] == 1
    if fault == "state_unchanged" and prefill_only:
        pytest.skip("prefill-only requests take no decode step")
    if fault == "altered_token" and prefill_only:
        pytest.skip("a prefill cell compares the prompt's logits, which a "
                    "sampler fault leaves alone; the decoding cell's "
                    "gap_mean holds the same sampler")
    if fault == "altered_answer" and not prefill_only:
        pytest.skip("a decoding cell's altered answer is altered_token")
    if fault == "half_batch" and \
            TINY_TRAFFIC[cell.split(".", 1)[1]]["batch"]["prompts"] == 1:
        pytest.skip("a request of one prompt has no half to leave out")
    FAULTS[fault](monkeypatch)
    res = _run(root32, cell)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(root32, cell):
    res = _run(root32, cell, trace=True)
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU the profiler sees no device: only the idle share and the
    # program's own clocks read anything
    assert res["metrics"]["idle_share." + ("prefill" if "prefill" in cell
                                           else "decode")]["value"] == 100.0


def control_numbers(root, cell, dev, n_requests=3):
    """The program's and the float8 control's numbers over the first
    ``n_requests`` requests of the cell's schedule (a fixed sample, so
    that the test does not depend on how many requests a short window
    holds), and the cell's limits."""
    import itertools
    from benchlib import cells, model, traffic
    from repro_torch.launch import serve
    from repro_torch.models import lm
    bench = cells.benchmark(root)
    w = cells.cell(bench, cell)
    c = cells.config(bench, w["config"], root)["as_run"]
    tr = cells.traffic(w["traffic"], root)
    cfg = model.arch_config(c)
    params = model.make_weights(ref.leaf_specs(c), SEED, dev)
    served = []
    for i, shape in enumerate(itertools.islice(traffic.schedule(tr, SEED),
                                               n_requests)):
        prompts = traffic.prompts(shape, c["vocab"], SEED, i, dev)
        g = serve.generate(params, cfg, prompts, shape.gen_tokens)
        pos = check.positions(shape.prompt_len, tr["check"]["positions"],
                              SEED, i)
        with torch.no_grad():
            full = lm.forward(params, cfg, prompts)
        served.append(check.Served(prompts, g.tokens, pos,
                                   full[:, pos].clone()))
    nums = check.numbers(ref, params, c, served, list(range(n_requests)),
                         control=True)
    return nums, cells.limits(cell, root)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(tiny_root, cell):
    """The float8 control, read at the program's positions, fails the
    cell's limits where the bf16 program passes them."""
    nums, lim = control_numbers(tiny_root, cell, CPU)
    assert check.verdict(nums["program"], lim)["ok"], nums
    assert not check.verdict(nums["control"], lim)["ok"], nums
