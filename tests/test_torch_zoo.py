"""The port's config zoo (``repro_torch.configs``) against the reference's:
the twelve architectures in the reference's order, each full-size
``CONFIG`` and ``reduced()`` equal field for field (the port's own
options, which the published Jamba block needs, at the defaults that keep
the reference's model), and the workload
extraction (``repro_torch.workload.extract``) of every architecture at
full width equal to the reference's for each phase and datapath dtype."""
import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.workload.extract import extract as ref_extract
from repro_torch import configs
from repro_torch.workload.extract import DTYPES, PHASES, extract


def test_arch_ids_are_the_reference_zoo_in_order():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 12


# fields of the port's config the reference's lacks, each with the value
# that keeps the reference's model
PORT_OPTIONS = {"rope": True, "attn_offset": 0,
                "moe": {"renormalize": True},
                "mamba": {"dt_rank": 1, "inner_norms": False}}


def _reference_fields(d: dict, options: dict = PORT_OPTIONS) -> dict:
    """A port config's ``asdict`` with the port's own options taken out,
    each checked to hold its default."""
    out = dict(d)
    for k, v in options.items():
        if isinstance(v, dict):
            if out[k] is not None:
                out[k] = _reference_fields(out[k], v)
        else:
            assert out.pop(k) == v, k
    return out


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_and_reduced_equal_the_reference(arch):
    assert _reference_fields(dataclasses.asdict(configs.get_config(arch))) \
        == dataclasses.asdict(ref_configs.get_config(arch))
    assert _reference_fields(dataclasses.asdict(configs.get_reduced(arch))) \
        == dataclasses.asdict(ref_configs.get_reduced(arch))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_extraction_equals_the_reference_at_full_width(arch, phase, dtype):
    got = extract(configs.get_config(arch), seq_len=2048, batch=3,
                  phase=phase, dtype=dtype)
    want = ref_extract(ref_configs.get_config(arch), seq_len=2048, batch=3,
                       phase=phase, dtype=dtype)
    np.testing.assert_array_equal(np.asarray(got.features),
                                  np.asarray(want.features))
    assert got.graph.names == want.graph.names
    for field in ("kind", "flops", "weight_bytes", "out_bytes"):
        np.testing.assert_array_equal(getattr(got.graph, field),
                                      getattr(want.graph, field))
    assert [tuple(e) for e in got.graph.edges] == \
        [tuple(e) for e in want.graph.edges]
