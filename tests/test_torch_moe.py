"""The port's MoE layer (`repro_torch.models.moe`) against the JAX
package's `models/moe.py`, on the CPU.

The parameters are the JAX package's `init_params` of the layer's schema,
carried across as float32 numpy arrays; inputs are drawn from a numpy
seed. Both sides route in float32 and compute the experts in float32
(the reduced configs' compute dtype), so the tolerance is float32's:
outputs of order 1 summed over <= 64 terms in another order are held to
atol = rtol = 2e-5, the aux loss to rtol 1e-6. Routing is compared
exactly: every token's top-k experts and which of its k choices kept a
capacity slot.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe

TOL = dict(atol=2e-5, rtol=2e-5)
AUX_TOL = dict(atol=0.0, rtol=1e-6)


def _cfgs(name, **moe_kw):
    """(reference config, port config) of reduced ``name``, the MoE
    settings replaced by ``moe_kw``."""
    jc = j_reduced(j_get_config(name))
    tc = reduced(get_config(name))
    return (dataclasses.replace(jc, moe=dataclasses.replace(jc.moe,
                                                            **moe_kw)),
            dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                            **moe_kw)))


def _params(jcfg, seed=0):
    p = j_layers.init_params(jax.random.PRNGKey(seed),
                             j_moe.moe_schema(jcfg), jnp.float32)
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)


def _run_both(jcfg, tcfg, x, seed=0):
    jp, tp = _params(jcfg, seed)
    want, jaux = j_moe.moe_layer(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_layer(tp, torch.from_numpy(x), tcfg)
    return np.asarray(want), float(jaux), got.numpy(), float(aux), jp, tp


def _kept(params, x, cfg):
    """The reference's combine tensor's nonzero (group, token, expert,
    slot) set, from the JAX layer's own intermediate formulas, beside
    the port's (both from their own router): equal sets mean the same
    tokens kept the same capacity slots."""
    sets = []
    for xp, lib in ((jnp.asarray(x), "jax"), (torch.from_numpy(x), "torch")):
        m = cfg.moe
        T = x.shape[0] * x.shape[1]
        sg = min(m.group_size, T)
        while T % sg:
            sg -= 1
        C = moe._capacity(sg, m.top_k, m.num_experts, m.capacity_factor)
        if lib == "jax":
            xg = xp.reshape(T // sg, sg, -1)
            probs = jax.nn.softmax(xg @ jnp.asarray(params[0]["router"]), -1)
            _, idx = jax.lax.top_k(probs, m.top_k)
            idx = np.asarray(idx)
        else:
            xg = xp.reshape(T // sg, sg, -1)
            probs = torch.softmax(xg @ params[1]["router"], -1)
            idx = moe.top_k(probs, m.top_k)[1].numpy()
        counts = np.zeros((T // sg, m.num_experts), int)
        kept = set()
        for slot in range(m.top_k):
            for g in range(T // sg):
                for s in range(sg):
                    e = idx[g, s, slot]
                    if counts[g, e] < C:
                        kept.add((g, s, int(e), slot))
                    counts[g, e] += 1
        sets.append(kept)
    return sets


@pytest.mark.parametrize("name", ["deepseek-moe-16b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_layer_matches_the_reference(name, rng):
    """Reduced deepseek (4 experts top-2, 2 fused shared experts) and
    llama4 (top-1, 1 shared expert): output and aux loss."""
    jcfg, tcfg = _cfgs(name)
    x = rng.normal(size=(2, 32, tcfg.d_model)).astype(np.float32)
    want, jaux, got, aux, jp, tp = _run_both(jcfg, tcfg, x)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, jaux, **AUX_TOL)
    assert aux > 0


@pytest.mark.parametrize("factor", [0.25, 0.5])
def test_capacity_factor_that_drops_tokens(factor, rng):
    """A capacity under the routed load drops tokens: the same tokens
    keep the same slots, and the outputs agree."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b", capacity_factor=factor)
    x = rng.normal(size=(2, 32, tcfg.d_model)).astype(np.float32)
    jp, tp = _params(jcfg)
    ref_kept, port_kept = _kept((jp, tp), x, tcfg)
    assert ref_kept == port_kept
    assert len(port_kept) < 2 * 32 * tcfg.moe.top_k      # some dropped
    want, jaux, got, aux, _, _ = _run_both(jcfg, tcfg, x)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, jaux, **AUX_TOL)


@pytest.mark.parametrize("B,S", [(1, 27), (3, 7), (1, 1)])
def test_odd_token_counts_take_the_largest_divisor(B, S, rng):
    """T = 27 groups by 9, T = 21 by 7, T = 1 by 1 (group size 16)."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    want, jaux, got, aux, _, _ = _run_both(jcfg, tcfg, x)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(aux, jaux, **AUX_TOL)


def test_top_k_orders_ties_as_the_reference(rng):
    """Probabilities drawn from a few levels, so most rows hold ties:
    values and indices equal `jax.lax.top_k`'s exactly."""
    p = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    for k in (1, 2, 6, 16):
        wv, wi = jax.lax.top_k(jnp.asarray(p), k)
        gv, gi = moe.top_k(torch.from_numpy(p), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_built_router_tie_routes_as_the_reference(rng):
    """Two identical router columns tie every token's probabilities for
    experts 1 and 2 exactly; with top-2 at a capacity that overflows, the
    lower expert index takes the first choice and the tokens that
    overflow are the reference's."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b", capacity_factor=0.5)
    jp, tp = _params(jcfg)
    router = np.array(jp["router"])
    router[:, 2] = router[:, 1]
    router[:, 1:3] += 3.0 * np.abs(router[:, :1])   # make them the top two
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.abs(rng.normal(size=(1, 32, tcfg.d_model))).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x[0]) @ tp["router"], -1)
    assert torch.equal(probs[:, 1], probs[:, 2])
    idx = moe.top_k(probs, 2)[1]
    assert (idx[:, 0] == 1).all() and (idx[:, 1] == 2).all()
    ref_kept, port_kept = _kept((jp, tp), x, tcfg)
    assert ref_kept == port_kept
    want, jaux = j_moe.moe_layer(jp, jnp.asarray(x), jcfg)
    got, aux = moe.moe_layer(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **AUX_TOL)


def test_dense_oracle_when_nothing_drops(rng):
    """Capacity >= group size (tests/test_models.py's setting): the
    GShard dispatch equals the run-every-expert oracle, and the port's
    oracle equals the reference's."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b", capacity_factor=8.0,
                       group_size=16)
    jp, tp = _params(jcfg)
    x = rng.normal(size=(2, 32, tcfg.d_model)).astype(np.float32)
    got, aux = moe.moe_layer(tp, torch.from_numpy(x), tcfg)
    oracle = moe.moe_layer_dense_oracle(tp, torch.from_numpy(x), tcfg)
    want = j_moe.moe_layer_dense_oracle(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=1e-4,
                               rtol=1e-3)
    assert float(aux) >= 0


def test_capacity_rule():
    for sg, k, E, f in [(128, 6, 64, 1.25), (4, 6, 64, 1.25), (16, 2, 4, 1.25),
                        (9, 2, 4, 0.5), (128, 1, 128, 1.25)]:
        assert moe._capacity(sg, k, E, f) == j_moe._capacity(sg, k, E, f)
