"""What the harness and the reference import, and the traffic generator's
repeatability."""
import ast
import itertools
import json
import subprocess
import sys
from collections import Counter

import pytest
import torch

from conftest import BENCH, ROOT
from benchlib import cells, traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REFERENCE_MAY = {"__future__", "math", "typing", "numpy", "torch"}


def _imports(path):
    """Top-level names of the modules a file imports (whole names: the
    part before the first dot)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= REFERENCE_MAY


def test_loaded_modules_hold_no_jax():
    """In a fresh process, the harness with the program and the reference
    load neither JAX nor the JAX package (``repro_torch`` starts with
    ``repro``: names are compared whole), and the reference alone loads
    nothing of the program."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]\n"
        "import reference.lm\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'repro_torch' not in top and 'benchlib' not in top, top\n"
        "from benchlib import runner, tracing, check, model\n"
        "import counts.lm, loops.serve\n"
        "from repro_torch.launch import serve\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert "repro_torch" in top and not top & FORBIDDEN


def test_command_refuses_a_machine_without_a_card(tmp_path):
    """Without a CUDA device the command prints no result and exits with
    another code than 0."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "mixtral.prefill-mooncake",
                          "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


MIXES = ["prefill-mooncake", "chat-sharegpt"]


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_repeats_from_a_seed_and_differs_across_seeds(mix):
    tr = cells.traffic(mix)
    take = lambda seed: [s.prompt_len for s in
                         itertools.islice(traffic.schedule(tr, seed), 48)]
    big = 2**31 + 977
    assert take(big) == take(big)
    assert take(big) != take(big + 1)
    shape = traffic.shape_of(tr, traffic.prompt_lengths(tr)[0])
    a = traffic.prompts(shape, 1000, big, 3, "cpu")
    assert torch.equal(a, traffic.prompts(shape, 1000, big, 3, "cpu"))
    assert not torch.equal(a, traffic.prompts(shape, 1000, big + 1, 3, "cpu"))
    assert not torch.equal(a, traffic.prompts(shape, 1000, big, 4, "cpu"))


@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_serves_the_same_lengths(mix):
    """Each cycle is the mix's whole multiset of lengths, served as pairs
    of the i-th shortest and the i-th longest (the middle one alone)."""
    tr = cells.traffic(mix)
    lens = traffic.prompt_lengths(tr)
    n = len(lens)
    assert len(set(lens)) == n
    partner = {lens[i]: lens[n - 1 - i] for i in range(n)}
    for seed in (0, 5, 2**31 + 3):
        stream = [s.prompt_len for s in
                  itertools.islice(traffic.schedule(tr, seed), 3 * n)]
        for k in range(3):
            cycle = stream[k * n:(k + 1) * n]
            assert Counter(cycle) == Counter(lens)
            j = 0
            while j < n:
                if partner[cycle[j]] == cycle[j]:
                    j += 1
                    continue
                assert cycle[j + 1] == partner[cycle[j]]
                j += 2


@pytest.mark.parametrize("mix", MIXES)
def test_mean_prompt_is_the_published_one(mix):
    """The multiset's mean prompt length is within 1% of the mean that
    the mix's source publishes."""
    tr = cells.traffic(mix)
    lens = traffic.prompt_lengths(tr)
    mean = sum(lens) / len(lens)
    assert abs(mean / tr["prompt_len"]["published_mean"] - 1) < 0.01
    assert all(n % tr["prompt_len"]["multiple"] == 0 for n in lens)


def test_every_prefill_request_takes_the_grouped_dispatch():
    tr = cells.traffic("prefill-mooncake")
    for s in traffic.shapes(tr):
        assert s.prompt_tokens > 512 and s.gen_tokens == 1
