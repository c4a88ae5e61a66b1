"""The port's serving CLI, ``python -m repro_torch.launch.serve``: it runs
on the CPU when asked, raises for a card that is not there, and refuses a
``--recommend`` root that holds no campaign with a one-line error."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.launch import serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch", [
    "llama3.1-8b", "jamba-v0.1-52b", "smolvlm", "smollm-135m", "qwen1.5-110b",
    "qwen2-72b", "mixtral-8x7b", "llama4-maverick-400b-a17b"])
def test_serve_cli_runs_on_the_cpu(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--reduced", "--batch", "2", "--prompt-len", "6", "--gen", "4",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"[serve] {arch}: prefill 6 tok x2" in out.stdout
    assert "tok/s (batch=2, cpu)" in out.stdout


def test_serve_returns_greedy_tokens_and_launches_no_kernel_on_the_cpu():
    ops.reset_launch_counts()
    tokens, tok_s = serve.serve("jamba-v0.1-52b", batch=2, prompt_len=5,
                                gen_tokens=3, device="cpu")
    assert tokens.shape == (2, 3) and tokens.dtype == np.int32
    assert ((tokens >= 0) & (tokens < 256)).all()
    assert np.isfinite(tok_s) and tok_s > 0
    assert set(ops.launch_counts().values()) == {0}
    again, _ = serve.serve("jamba-v0.1-52b", batch=2, prompt_len=5,
                           gen_tokens=3, device="cpu")
    np.testing.assert_array_equal(tokens, again)   # seeded


def test_serve_inputs_come_from_separate_streams():
    cfg = serve.get_reduced("smolvlm")
    params, prompts, ctx = serve.inputs(cfg, 2, 8, 0, "cpu")
    assert prompts.shape == (2, 8) and ctx.shape == (2, 8, 64)
    assert ctx.dtype == torch.bfloat16
    # no draw repeats another's noise
    emb = params["embed"]["w"].float().flatten()[:16] / 0.02
    assert not torch.allclose(emb, ctx.float().flatten()[:16] / 0.1,
                              atol=1e-2)


def test_serve_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "llama3.1-8b", "--reduced", "--device",
                    "cuda"])


def test_serve_cli_refuses_recommend(tmp_path, capsys):
    """``--recommend`` on a root with no campaign is a one-line error."""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--recommend", str(tmp_path / "nope"), "--device",
                    "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].endswith(f"--recommend: no campaign manifest at "
                            f"{tmp_path / 'nope' / 'manifest.json'}")
    assert "Traceback" not in "\n".join(err)


@pytest.mark.parametrize("arch,name", [
    ("minicpm3-4b", "MLA"), ("llama-3.2-vision-90b", "xattn"),
    ("whisper-medium", "the Whisper encoder"), ("xlstm-1.3b", "mlstm")])
def test_serve_refuses_the_zoo_parts_not_ported_by_name(arch, name):
    """The four architectures this test once found refused by ``name`` are
    ported: each now serves through ``serve`` on the CPU (its own bf16
    weights, prompts and context from ``inputs``), and its prefill logits
    agree with the reference's prefill on the same weights within 5e-2 of
    max |logit|, the bf16 bound of ``tests/test_torch_lm.py``."""
    import jax.numpy as jnp

    from repro.models import lm as ref_lm
    from repro.configs import get_reduced as ref_reduced
    tokens, tok_s = serve.serve(arch, batch=2, prompt_len=5, gen_tokens=3,
                                device="cpu")
    assert tokens.shape == (2, 3) and np.isfinite(tok_s) and tok_s > 0
    cfg = serve.get_reduced(arch)
    params, prompts, ctx = serve.inputs(cfg, 2, 5, 0, "cpu")
    got = serve.generate(params, cfg, prompts, 3, ctx)
    np.testing.assert_array_equal(got.tokens, tokens)      # serve's own

    def to_jax(t):
        if isinstance(t, dict):
            return {k: to_jax(v) for k, v in t.items()}
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
        return jnp.asarray(t.numpy())
    want, _ = ref_lm.prefill(to_jax(params), ref_reduced(arch),
                             jnp.asarray(prompts.numpy().astype(np.int32)),
                             None if ctx is None else to_jax(ctx))
    want = np.asarray(want, np.float32)
    err = np.abs(got.prefill_logits.float().numpy() - want).max()
    assert err < 5e-2 * np.abs(want).max(), name
