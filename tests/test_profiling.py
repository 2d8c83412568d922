"""Profiling utilities, the peak table and the compile-cache helper."""

import types

import jax
import jax.numpy as jnp
import pytest

from kmers_tpu import compile_cache, profiling

H100_SXM = types.SimpleNamespace(platform="gpu",
                                 device_kind="NVIDIA H100 80GB HBM3")


def test_timer_and_roofline():
    t = profiling.Timer()
    for _ in range(3):
        with t.round():
            jnp.zeros(16).block_until_ready()
    assert len(t.times) == 3 and t.best > 0
    r = profiling.roofline(1e9, 18.0, device=H100_SXM)
    assert r["peak_gbps"] == 3350.0
    assert r["achieved_gbps"] == 18.0
    assert r["fraction"] == pytest.approx(18.0 / 3350.0)


@pytest.mark.parametrize("kind,gbps", [("NVIDIA H100 80GB HBM3", 3350.0),
                                       ("NVIDIA H100 PCIe", 2000.0),
                                       ("NVIDIA H100 NVL", 3900.0)])
def test_peak_table_known_kinds(kind, gbps):
    dev = types.SimpleNamespace(platform="gpu", device_kind=kind)
    assert profiling.device_hbm_gbps(dev) == gbps
    assert profiling.PEAK_HBM_GBPS[kind].source   # every peak names a source


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "cpu", ""])
def test_peak_table_unknown_kind_raises(kind):
    dev = types.SimpleNamespace(platform="gpu", device_kind=kind)
    with pytest.raises(ValueError, match="no published peak"):
        profiling.device_hbm_gbps(dev)


def test_peak_of_the_cpu_raises():
    with pytest.raises(ValueError):
        profiling.device_hbm_gbps(jax.devices("cpu")[0])


def test_metrics_accumulator():
    m = profiling.MetricsAccumulator()
    m.update({"reads": 4, "kmers_emitted": 100})
    m.update({"reads": 2, "kmers_emitted": 50, "route_overflow": 1})
    assert m["reads"] == 6
    assert m["kmers_emitted"] == 150
    assert m["route_overflow"] == 1
    assert m.summary()["steps"] == 2


@pytest.fixture
def restore_cache_config():
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compile_cache_env_set_changes_nothing(monkeypatch, tmp_path,
                                               restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 1.0


def test_compile_cache_env_unset_uses_checkout(monkeypatch,
                                               restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.configure()
    assert path == compile_cache.DEFAULT_DIR
    assert path.endswith("/.jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # fixed: the same path on every call, in every process
    assert compile_cache.configure() == path
    import kmers_tpu

    assert compile_cache.CHECKOUT == kmers_tpu.__path__[0].rsplit("/", 1)[0]
