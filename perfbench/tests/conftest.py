"""Shared set-up of the benchmark's tests: the harness and the program on
the path, and a checkout in miniature (``tiny_root``) whose cells run the
real harness, metrics and limits on configurations small enough for the
CPU.  Run them with ``python -m pytest -q perfbench/tests``; the tests
marked ``cuda`` skip without a card."""
import copy
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "tiny-moe": dict(
        name="tiny-moe", family="moe", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, norm_eps=1e-5,
        rope_theta=1e6, sliding_window=0, attn_period=0,
        moe=dict(n_experts=4, top_k=2, every=1), mamba=None,
        param_dtype="bfloat16", period=[dict(kind="attn", moe=True)],
        moe_dispatch=dict(dropless_max_tokens=512, group_tokens=8192,
                          capacity_factor=1.25)),
}

TINY_TRAFFIC = {
    "prefill-mooncake": dict(
        loop="serve",
        prompt_len=dict(dist="loguniform", min=160, max=1024, multiple=32,
                        levels=4),
        batch=dict(prompts=1), gen_tokens=1,
        check=dict(max_requests=3, ref_tokens=4096, positions=16)),
    "chat-sharegpt": dict(
        loop="serve",
        prompt_len=dict(dist="grid", min=32, max=64, multiple=16),
        batch=dict(prompts=4), gen_tokens=8,
        check=dict(max_requests=2, ref_tokens=4096, positions=16)),
}

# each tiny cell stands for the real cell of the same traffic and model
# kind, and is held to that cell's limits
REAL = {"tiny-moe": "mixtral"}


def as_run(name: str, dtype: str = "bfloat16") -> dict:
    c = copy.deepcopy(TINY[name])
    c["param_dtype"] = dtype
    return c


def make_root(tmp: Path, dtype: str = "bfloat16") -> Path:
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp / "perfbench" / "configs").mkdir(parents=True)
    (tmp / "perfbench" / "traffic").mkdir()
    (tmp / "perfbench" / "limits").mkdir()
    configs, workloads = [], []
    for name in TINY:
        path = f"perfbench/configs/{name}.json"
        (tmp / path).write_text(json.dumps(dict(
            name=name, reference="reference/lm.py", counts="counts/lm.py",
            as_run=as_run(name, dtype))))
        configs.append(dict(name=name, file=path))
        for traffic, tr in TINY_TRAFFIC.items():
            cell = f"{name}.{traffic}"
            (tmp / "perfbench" / "traffic" / f"{traffic}.json").write_text(
                json.dumps(tr))
            real_cell = f"{REAL[name]}.{traffic}"
            (tmp / "perfbench" / "limits" / f"{cell}.json").write_text(
                (BENCH / "limits" / f"{real_cell}.json").read_text())
            workloads.append(dict(name=cell, config=name, traffic=traffic,
                                  chips=1, real=real_cell))
    renamed = {w["real"]: w["name"] for w in workloads}
    bench = dict(real, configs=configs, workloads=workloads)
    for group in ("end_to_end", "per_layer"):
        bench[group] = [dict(m, workloads=[renamed[w] for w in m["workloads"]])
                        if "workloads" in m else m for m in real[group]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    torch.manual_seed(0)
    return make_root(tmp_path)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
