"""The sharded step on the multi-pod axes (pod 2, data 1, model 2): the
cases of ``test_torch_sharded_step.py`` on that mesh, with its tolerances,
in a file of its own, so that the two meshes' groups of 4 gloo ranks run on
two workers.  Every family against the unsharded port; against ``repro``'s
step on a forced 4-device mesh of the same axes (a subprocess beside the
ranks) the dense and local/global families, whose XLA compiles are the
cheapest to wait for (the other families are held against ``repro`` on
the 2 x 2 mesh).  The int8 moments and compressed gradients, whose blocks
run over the whole leaf whatever the mesh, are held on the 2 x 2 mesh.
"""

import pytest
import test_torch_sharded_step as base
import torch
from test_torch_sharded_step import cases, unsharded  # noqa: F401  (module fixtures)

from repro_torch.core import topology as ttopo

torch.set_num_threads(1)

MESH = "pod2_data1_model2"
#: the families held against ``repro`` on this mesh
REF_ARCHS = base.QUANTIZED_ARCHS


@pytest.fixture(scope="module")
def reference(cases):  # noqa: F811
    yield from base.start_reference(cases, (MESH,), REF_ARCHS)


@pytest.fixture(scope="module")
def sharded(reference):
    return ttopo.spawn_ranks(base._rank, 4, (MESH, False), device="cpu")[0]


@pytest.fixture(scope="module")
def reference_out(reference, sharded):
    return base.finish_reference(reference)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_train_step_matches_the_reference(arch, sharded, reference_out):
    base.check_reference(sharded[arch], reference_out, MESH, arch)


@pytest.mark.parametrize("arch", base.ARCHS)
def test_train_step_matches_unsharded(arch, sharded, unsharded):  # noqa: F811
    base.check_unsharded(sharded[arch], unsharded[arch])


@pytest.mark.parametrize("arch", base.ARCHS)
def test_new_state_keeps_its_placements(arch, sharded):
    base.check_placements(sharded[arch])



@pytest.mark.parametrize("arch", base.ARCHS)
def test_prefill_and_decode_match_unsharded(arch, sharded, unsharded):  # noqa: F811
    base.check_serve(sharded[arch], unsharded[arch])
