"""The port's config zoo (``repro_torch.configs``) against the reference's:
the twelve architectures in the reference's order, each full-size
``CONFIG`` and ``reduced()`` equal field for field, and the workload
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


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_config_and_reduced_equal_the_reference(arch):
    assert dataclasses.asdict(configs.get_config(arch)) == \
        dataclasses.asdict(ref_configs.get_config(arch))
    assert dataclasses.asdict(configs.get_reduced(arch)) == \
        dataclasses.asdict(ref_configs.get_reduced(arch))


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
