"""The port's compressed all-reduce (`repro_torch.train.compress.
psum_compressed`) against the JAX package's, on the CPU.

Four per-rank inputs are drawn with numpy (seed 5; a size that is not a
multiple of the 256-value block, and one rank's values 1e3 times the
others', so that the blocks' scales differ). The reference runs its
``shard_map`` collective on 4 forced host devices in a subprocess (Auto
axes, ROADMAP C.2); the port runs one gloo rank a device
(`test_torch_gpipe.run_ranks`). Every rank's sum within 1e-6 relative of
the reference's. At world size 1 the collective is the quantization
round trip, bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.train.compress import (dequantize_block_int8,
                                        psum_compressed, quantize_block_int8)
from test_torch_gpipe import reference_subprocess, run_ranks

SHAPE = (37, 29)
_REF = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, Mesh, PartitionSpec as P
from repro.train.compress import psum_compressed
rng = np.random.default_rng(5)
xs = rng.normal(size=(4, 37, 29)).astype(np.float32)
xs[2] *= 1e3
mesh = Mesh(np.array(jax.devices()[:4]), ("data",),
            axis_types=(AxisType.Auto,))
f = jax.shard_map(lambda x: psum_compressed(x[0], "data")[None], mesh=mesh,
                  in_specs=P("data"), out_specs=P("data"))
print(json.dumps(np.asarray(jax.jit(f)(jnp.asarray(xs))).tolist()))
"""
_RANK = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.train.compress import psum_compressed
mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
rng = np.random.default_rng(5)
xs = rng.normal(size=(4, 37, 29)).astype(np.float32)
xs[2] *= 1e3
save(psum_compressed(torch.tensor(xs[rank]), "data", mesh=mesh))
"""


def test_four_ranks_match_reference(tmp_path):
    want = np.asarray(reference_subprocess(_REF, 4))
    got = run_ranks(tmp_path, 4, _RANK)
    for r, g in enumerate(got):
        assert tuple(g.shape) == SHAPE
        err = float(np.abs(g.numpy() - want[r]).max()
                    / np.abs(want[r]).max())
        assert err <= 1e-6, (r, err)
    # the compression is real: the sum differs from the exact one
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(4,) + SHAPE).astype(np.float32)
    xs[2] *= 1e3
    assert float(np.abs(got[0].numpy() - xs.sum(0)).max()) > 0


@pytest.fixture
def one_rank():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("block", [256, 64])
def test_one_rank_is_the_quantization_round_trip(one_rank, block):
    x = torch.tensor(np.random.default_rng(6).normal(
        size=SHAPE).astype(np.float32))
    q, s = quantize_block_int8(x, block)
    assert torch.equal(psum_compressed(x, "data", block=block,
                                       mesh=one_rank),
                       dequantize_block_int8(q, s, x.shape))
