"""The port's gradient compression (``repro_torch.distributed.
compression``) against the JAX reference's: ``compress``/``decompress``
bitwise over seeds and scales; error feedback's convergence (the
counterpart of ``test_compression_error_feedback_converges``, at the same
tolerance); and ``compressed_psum`` on 1 and 4 gloo ranks against the
reference's ``shard_map`` on 1 and 4 host devices (a subprocess with
``XLA_FLAGS``), two rounds (the second with the residuals the first
left), bitwise: the scales are a max, the payload an integer sum."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as ref
from repro_torch.distributed import compression as comp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from test_torch_sharded_train import _env, run_ranks  # noqa: E402

REFERENCE = r"""
import os, sys
import jax, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.compression import compressed_psum
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
world, out = int(sys.argv[1]), sys.argv[2]
rng = np.random.default_rng(11)
g = dict(a=rng.normal(0, 1, (world, 37)).astype(np.float32),
         b=(rng.normal(0, 1, (world, 4, 5)) * 100).astype(np.float32))
def body(g, r):
    o, nr = compressed_psum(jax.tree.map(lambda x: x[0], g),
                            jax.tree.map(lambda x: x[0], r), "dp")
    return o, jax.tree.map(lambda x: x[None], nr)
f = shard_map(body, mesh=Mesh(np.array(jax.devices()[:world]), ("dp",)),
              in_specs=(P("dp"), P("dp")), out_specs=(P(), P("dp")))
o1, r1 = f(g, jax.tree.map(np.zeros_like, g))
o2, _ = f(g, r1)
np.savez(os.path.join(out, f"ref{world}.npz"),
         **{f"out1/{k}": np.asarray(v) for k, v in o1.items()},
         **{f"out2/{k}": np.asarray(v) for k, v in o2.items()},
         **{f"r1/{k}": np.asarray(v)[0] for k, v in r1.items()})
"""


@pytest.mark.parametrize("seed,scale,shape", [
    (0, 1.0, (1000,)), (1, 1e-3, (17, 33)), (2, 300.0, (8, 8, 8)),
    (3, 1e-13, (5,)), (4, 1.0, (1,))],
    ids=["unit", "small", "large", "below-floor", "one"])
def test_compress_decompress_bitwise(seed, scale, shape):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, shape) * scale).astype(np.float32)
    r = (rng.normal(0, 1, shape) * scale * 1e-2).astype(np.float32)
    q, s_, nr = comp.compress(torch.from_numpy(x), torch.from_numpy(r))
    rq, rs, rnr = ref.compress(jnp.asarray(x), jnp.asarray(r))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s_.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(nr.numpy(), np.asarray(rnr))
    np.testing.assert_array_equal(comp.decompress(q, s_).numpy(),
                                  np.asarray(ref.decompress(rq, rs)))


def test_error_feedback_converges():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (1000,)).astype(np.float32))
    resid = torch.zeros_like(x)
    acc = torch.zeros_like(x)
    for _ in range(50):
        q, scale, resid = comp.compress(x, resid)
        acc = acc + comp.decompress(q, scale)
    np.testing.assert_allclose((acc / 50).numpy(), x.numpy(), atol=2e-2)


@pytest.mark.parametrize("world", [1, 4])
def test_compressed_psum_matches_reference_shard_map(tmp_path, world):
    p = subprocess.run(
        [sys.executable, "-c", REFERENCE, str(world), str(tmp_path)],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS=f"--xla_force_host_platform_device_count={world}"),
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    run_ranks("psum", world, str(tmp_path / "store"), tmp_path)
    got = dict(np.load(tmp_path / f"psum{world}.npz"))
    want = dict(np.load(tmp_path / f"ref{world}.npz"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].reshape(want[k].shape),
                                      want[k], err_msg=k)
