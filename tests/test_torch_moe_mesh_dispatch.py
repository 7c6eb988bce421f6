"""Port parity: the einsum and scatter MoE dispatches under an ep-bearing
mesh against the JAX single-device step, the checks of
``tests/test_torch_moe_mesh.py`` (which holds the cases' helpers): einsum
under (fsdp 2, ep 2) at capacity factor 0.5, where tokens drop (each
shard slices the per-sequence capacity buffers to its experts; the drops
equal one device's), and scatter under (ep 2, tp 2).
"""

import pytest
import torch

import test_torch_moe_mesh as base

torch.set_num_threads(1)


@pytest.mark.parametrize("dispatch,axes,policy,cf", base.DISPATCH_CASES,
                         ids=base.case_ids(base.DISPATCH_CASES))
def test_moe_dispatch_mesh_step_matches_the_jax_single_device_step(
        dispatch, axes, policy, cf, tmp_path):
    base.run_case(dispatch, axes, policy, cf, tmp_path)
