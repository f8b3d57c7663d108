"""In-repo pytree dataclasses (utils/struct.py) and the compile-cache rule
(utils/cache.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libyafaray_tpu.utils import cache, struct


@struct.dataclass
class _Rec:
    a: jax.Array
    b: jax.Array = None
    size: int = struct.field(pytree_node=False, default=4)
    tag: tuple = struct.field(pytree_node=False, default=())


def test_struct_flatten_unflatten_roundtrip():
    r = _Rec(a=jnp.arange(3.0), b=jnp.ones(2), size=7, tag=("x",))
    leaves, tdef = jax.tree_util.tree_flatten(r)
    assert len(leaves) == 2          # static fields are not leaves
    back = jax.tree_util.tree_unflatten(tdef, leaves)
    assert back.size == 7 and back.tag == ("x",)
    np.testing.assert_array_equal(back.a, r.a)
    # a None data field is an empty subtree
    assert len(jax.tree_util.tree_leaves(_Rec(a=jnp.zeros(1)))) == 1
    doubled = jax.tree_util.tree_map(lambda x: 2 * x, r)
    np.testing.assert_array_equal(doubled.b, 2 * np.ones(2))
    assert doubled.size == 7


def test_struct_replace_and_frozen():
    r = _Rec(a=jnp.zeros(2))
    r2 = r.replace(size=9, b=jnp.ones(1))
    assert r.size == 4 and r.b is None
    assert r2.size == 9 and r2.b.shape == (1,)
    with pytest.raises(dataclasses.FrozenInstanceError):
        r.size = 3


def test_struct_static_fields_key_the_jit_cache():
    traces = []

    @jax.jit
    def f(rec):
        traces.append(rec.size)
        return rec.a * rec.size

    np.testing.assert_array_equal(f(_Rec(a=jnp.ones(2), size=2)), [2, 2])
    f(_Rec(a=jnp.asarray(np.full(2, 5.0, np.float32)), size=2))  # no retrace
    assert traces == [2]
    np.testing.assert_array_equal(f(_Rec(a=jnp.ones(2), size=3)), [3, 3])
    assert traces == [2, 3]                      # new static value: retrace


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_cache_dir_env_set_means_code_sets_none(monkeypatch, tmp_path):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert cache.setup_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_cache_dir_env_unset_uses_checkout_path(monkeypatch):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    calls = _record_updates(monkeypatch)
    got = cache.setup_compile_cache(min_compile_secs=3.0)
    repo = __file__.rsplit("/tests/", 1)[0]
    assert got == cache.DEFAULT_DIR == f"{repo}/.jax_cache"
    assert calls["jax_compilation_cache_dir"] == got
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 3.0
    with open(f"{repo}/.gitignore") as fh:
        assert ".jax_cache/" in fh.read().split()


def test_device_op_summary_counts_only_device_streams(tmp_path):
    """Host-thread spans in a GPU trace must not be counted as device
    time: only processes named /device:GPU:* contribute."""
    import gzip
    import json
    from libyafaray_tpu.utils.profiling import device_op_summary
    ev = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "name": "mt_query", "dur": 1500.0},
        {"ph": "X", "pid": 1, "name": "mt_query", "dur": 500.0},
        {"ph": "X", "pid": 1, "name": "fusion.3", "dur": 250.0},
        {"ph": "X", "pid": 2, "name": "PjitFunction(step)", "dur": 9e6},
        {"ph": "X", "pid": 2, "name": "mt_query", "dur": 7e6},
    ]
    d = tmp_path / "plugins" / "profile" / "run"
    d.mkdir(parents=True)
    with gzip.open(d / "host.trace.json.gz", "wt") as fh:
        json.dump({"traceEvents": ev}, fh)
    assert device_op_summary(str(tmp_path)) == [("mt_query", 2.0, 2),
                                                ("fusion.3", 0.25, 1)]
