"""The column-deal autotune cases of the reference
(`tests/test_stream_sharded.py::test_sharded_autotune_key_carries_device_count`,
`tests/test_load_aware.py::test_weighted_autotune_key_carries_share_signature`)
in both packages, on the CPU: the same calls leave the same cache keys
(the column count, the weighted deal's share signature), either
package's JSON loads in the other, and a tuned dealt call equals the
untuned single-column one bitwise. Kept apart from
`tests/test_torch_autotune.py` because the reference's interpret-mode
searches over four columns take most of the time of both files.
"""
import numpy as np
import pytest
import torch

from repro.core import autotune as jat
from repro.core.biosignal import make_app as j_make_app
from repro.core.biosignal import synthetic_respiration as j_synth
from repro.kernels.pipeline import ops as jops
from repro.kernels.pipeline.shard import column_shares as j_column_shares
from repro_torch.core import autotune as tat
from repro_torch.core.biosignal import app_from_numpy
from repro_torch.kernels.pipeline import ops
from repro_torch.kernels.pipeline.shard import column_shares
from repro_torch.serve.stream import frame_count


@pytest.fixture(scope="module")
def apps():
    japp = j_make_app()
    app = app_from_numpy(japp.fir_taps, np.asarray(japp.svm_w),
                         np.asarray(japp.svm_b), japp.fft_size, device="cpu")
    return japp, app


@pytest.fixture(autouse=True)
def _clean_caches():
    jat.clear_cache()
    tat.clear_cache()
    yield
    jat.clear_cache()
    tat.clear_cache()


def _raw(samples, seed):
    return np.asarray(j_synth(1, samples, seed=seed)[0][0])


def _same_keys():
    """The two packages' caches hold the same keys; returns the port's."""
    j, t = jat.cache_snapshot(), tat.cache_snapshot()
    assert set(j) == set(t), (sorted(j, key=str), sorted(t, key=str))
    return t


def _crosses_over(tmp_path):
    """Either package's JSON loads in the other with equal keys and
    winners."""
    jcache, tcache = jat.cache_snapshot(), tat.cache_snapshot()
    jpath, tpath = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    assert jat.save_cache(jpath) == len(jcache)
    assert tat.save_cache(tpath) == len(tcache)
    jat.clear_cache()
    tat.clear_cache()
    assert tat.load_cache(jpath) == len(jcache)
    assert tat.cache_snapshot() == jcache
    assert jat.load_cache(tpath) == len(tcache)
    assert jat.cache_snapshot() == tcache


def _identical(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_sharded_autotune_key_carries_device_count(apps, tmp_path):
    """`tests/test_stream_sharded.py:128`: the same traffic tuned at D=1
    and D=4 lands in distinct entries, and only the dealt one carries
    D."""
    japp, app = apps
    raw = _raw(512 * 8, seed=11)
    for d in (1, 4):
        jops.app_pipeline_stream(japp, raw, window=512, hop=256,
                                 autotune=True, n_columns=d, mesh=None)
        got = ops.app_pipeline_stream(app, torch.as_tensor(raw), window=512,
                                      hop=256, autotune=True, n_columns=d)
        _identical(got, ops.app_pipeline_stream(
            app, torch.as_tensor(raw), window=512, hop=256))
    keys = sorted(_same_keys(), key=len)
    assert len(keys) == 2
    assert keys[0][:2] == ("biosignal_pipeline_stream",
                           frame_count(512 * 8, 512, 256))
    assert keys[1][-1] == 4 and len(keys[1]) == len(keys[0]) + 1
    _crosses_over(tmp_path)


def test_weighted_autotune_key_carries_share_signature(apps, tmp_path):
    """`tests/test_load_aware.py:140`: a winner measured on a weighted
    deal must not leak onto the equal deal of the same traffic shape."""
    japp, app = apps
    raw = _raw(512 * 8, seed=21)
    for weights in (None, (1, 2, 2, 3)):
        jops.app_pipeline_stream(japp, raw, window=512, hop=256,
                                 autotune=True, n_columns=4,
                                 column_weights=weights)
        got = ops.app_pipeline_stream(app, torch.as_tensor(raw), window=512,
                                      hop=256, autotune=True, n_columns=4,
                                      column_weights=weights)
        _identical(got, ops.app_pipeline_stream(
            app, torch.as_tensor(raw), window=512, hop=256))
    keys = sorted(_same_keys(), key=len)
    assert len(keys) == 2
    n = frame_count(512 * 8, 512, 256)
    assert "w" not in keys[0]
    tail = keys[1][keys[1].index("w") + 1:]
    assert tail == column_shares(n, 4, (1, 2, 2, 3)) == \
        j_column_shares(n, 4, (1, 2, 2, 3))
    _crosses_over(tmp_path)
