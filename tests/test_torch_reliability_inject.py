"""The port's fault injection and crash fail-points against the JAX
reference on the CPU.

* ``bitflip``, ``plant_nan`` and ``corrupt_pytree`` give bytes identical to
  the reference's for the same seed and bit, in f32, bf16, int8 and
  fp8-e4m3 (drawn bits, repeated positions and the hit path included), and
  leave their input untouched.
* ``corrupt_kv_block`` poisons the pool the reference poisons (``k``;
  ``k_scale`` under the int8 KV pool), byte for byte, IN PLACE: the pool
  tensor is the same object at the same address.
* Fail-points: count, the three ``exc`` forms, re-arming, disarming, and
  the trip count under threads.  The ``BlockAllocator`` keeps its
  free/allocated partition under ``kv.alloc`` / ``kv.free`` crashes (the
  reference's property drill).  A checkpoint save crashed at
  ``checkpoint.save.mid_write`` (a leaf write on the writer threads) or
  ``.pre_rename`` leaves the previous step restorable and only an orphan
  that a new manager collects; a rotted leaf is named by its crc32.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from _hypothesis_shim import given, settings, st
from _torch_parity import reduced_configs
from repro import api as ref_api
from repro import reliability as ref_rel
from repro.serving import kv_cache as ref_kvc
from repro_torch import api, reliability as rel, tree as tree_lib
from repro_torch.checkpoint.manager import CheckpointManager, restore_pytree, save_pytree
from repro_torch.reliability.inject import InjectedFault, failpoint, maybe_fail
from repro_torch.serving import BlockAllocator
from repro_torch.serving import kv_cache as kvc

# each dtype on the reference side (numpy) and on the port's (torch)
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16),
          "int8": (np.int8, torch.int8),
          "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn)}


def _pair(name, shape=(32, 16), seed=0):
    """One random bit pattern as a reference array and a port tensor.
    Float patterns keep clear of NaN / Inf (a flipped bit may make one)."""
    np_t, torch_t = DTYPES[name]
    r = np.random.default_rng(seed)
    if name == "int8":
        a = r.integers(-127, 128, shape).astype(np.int8)
    else:
        a = r.normal(0, 1, shape).astype(np.float32).astype(np_t)
    signed = {4: np.int32, 2: np.int16, 1: np.uint8}[a.itemsize]  # torch views these
    return jnp.asarray(a), torch.from_numpy(a.view(signed).copy()).view(torch_t)


def _bytes(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().contiguous()
        w = t.element_size()
        return (t.view(torch.uint8) if w == 1 else t.view({2: torch.int16, 4: torch.int32}[w])).numpy() \
            .view(np.uint8).reshape(-1)
    return np.ascontiguousarray(np.asarray(t)).view(np.uint8).reshape(-1)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("bit,n_flips", [(None, 1), (None, 600), ("loud", 1), ("loud", 3)])
def test_bitflip_bytes_equal_reference(name, bit, n_flips):
    """600 flips over 512 elements repeat positions: a position drawn twice
    is flipped twice, as in the reference's loop."""
    ref, port = _pair(name)
    before = port.clone()
    if bit == "loud":
        bit = {"float32": 30, "bfloat16": 14}.get(name, 6)
    for seed in (0, 7, 12345):
        want = ref_rel.bitflip(ref, seed=seed, bit=bit, n_flips=n_flips)
        got = rel.bitflip(port, seed=seed, bit=bit, n_flips=n_flips)
        assert got.dtype == port.dtype and got.shape == port.shape
        assert np.array_equal(_bytes(got), _bytes(want)), (name, seed)
    assert np.array_equal(_bytes(port), _bytes(before))  # pure: the input is untouched


def test_bitflip_sign_bit_of_bf16_is_the_int16_minimum():
    t = torch.tensor([1.0, -2.0], dtype=torch.bfloat16)
    got = rel.bitflip(t, seed=0, bit=15, n_flips=1)
    assert got.tolist().count(-1.0) + got.tolist().count(2.0) == 1
    ref = jnp.asarray(np.array([1.0, -2.0], np.float32)).astype(jnp.bfloat16)
    assert np.array_equal(_bytes(got), _bytes(ref_rel.bitflip(ref, seed=0, bit=15)))


@pytest.mark.parametrize("name", ["float32", "bfloat16", "float8_e4m3fn"])
def test_plant_nan_bytes_equal_reference(name):
    ref, port = _pair(name)
    for seed, n in ((0, 1), (3, 5), (99, 40)):
        want = ref_rel.plant_nan(ref, seed=seed, n=n)
        got = rel.plant_nan(port, seed=seed, n=n)
        assert np.array_equal(_bytes(got), _bytes(want)), (name, seed, n)
    assert not torch.isnan(port.float()).any()
    with pytest.raises(ValueError, match="float"):
        rel.plant_nan(torch.zeros(3, dtype=torch.int8), seed=0)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16), bit=st.integers(0, 31))
def test_injection_is_deterministic(seed, bit):
    """The reference's property: the same seed, the same corruption; one
    element touched by one flip, one NaN planted."""
    arr = torch.from_numpy(np.random.default_rng(0).normal(size=(32, 16)).astype(np.float32))
    a, b = rel.bitflip(arr, seed=seed, bit=bit), rel.bitflip(arr, seed=seed, bit=bit)
    assert np.array_equal(_bytes(a), _bytes(b))
    assert int((_bytes(a).view(np.uint32) != _bytes(arr).view(np.uint32)).sum()) == 1
    n1, n2 = rel.plant_nan(arr, seed=seed), rel.plant_nan(arr, seed=seed)
    assert np.array_equal(_bytes(n1), _bytes(n2)) and int(torch.isnan(n1).sum()) == 1


def test_corrupt_pytree_targets_by_path_as_reference():
    r = np.random.default_rng(1)
    wn = r.normal(0, 1, (70, 40)).astype(np.float32)
    q, k = r.normal(0, 1, (4, 4)).astype(np.float32), r.normal(0, 1, (4, 4)).astype(np.float32)
    ref_tree = {"layers": {"q": jnp.asarray(q), "k": jnp.asarray(k), "w": ref_api.DipWeight.from_natural(jnp.asarray(wn))},
                "step": 3}
    tree = {"layers": {"q": torch.from_numpy(q), "k": torch.from_numpy(k),
                       "w": api.DipWeight.from_natural(torch.from_numpy(wn))}, "step": 3}
    for target, mode, bit in (("['k']", "nan", None), ("layers", "bitflip", 30), ("w", "bitflip", None),
                              ("w']/.data", "nan", None)):
        got, hit = rel.corrupt_pytree(tree, target, seed=4, mode=mode, bit=bit, n=2)
        want, ref_hit = ref_rel.corrupt_pytree(ref_tree, target, seed=4, mode=mode, bit=bit, n=2)
        assert hit == ref_hit, target
        for (p, a), b in zip(tree_lib.paths(got), jax.tree_util.tree_leaves(want)):
            if isinstance(a, torch.Tensor):
                assert np.array_equal(_bytes(a), _bytes(b)), (target, p)
    got, _ = rel.corrupt_pytree(tree, "k", seed=0, mode="nan")
    assert got["layers"]["q"] is tree["layers"]["q"] and not torch.isnan(tree["layers"]["k"]).any()
    with pytest.raises(KeyError):
        rel.corrupt_pytree(tree, "nonexistent", seed=0)
    with pytest.raises(ValueError, match="mode"):
        rel.corrupt_pytree(tree, "k", seed=0, mode="zero")


@pytest.mark.parametrize("kv_quant,mode", [("none", "nan"), ("none", "bitflip"), ("int8", "nan"),
                                           ("int8", "bitflip")])
def test_corrupt_kv_block_in_place_as_reference(kv_quant, mode):
    ref_cfg, cfg = reduced_configs(backend_ref="xla", backend_port="torch", dtype="bfloat16")
    kw = dict(num_blocks=6, block_size=8, slots=2, max_seq=32, kv_quant=kv_quant)
    ref_kv = ref_kvc.PagedKVCache(ref_cfg, **kw)
    kv = kvc.PagedKVCache(cfg, device="cpu", **kw)
    before = {nm: (t, t.data_ptr()) for nm, t in kv.pools["layers"].items()}
    name = rel.corrupt_kv_block(kv, 3, seed=5, mode=mode)
    ref_name = ref_rel.corrupt_kv_block(ref_kv, 3, seed=5, mode=mode)
    assert name == ref_name == ("k" if kv_quant == "none" else "k_scale")
    for nm, t in kv.pools["layers"].items():
        assert t is before[nm][0] and t.data_ptr() == before[nm][1], nm  # in place
        assert np.array_equal(_bytes(t), _bytes(ref_kv.pools["layers"][nm])), nm
    pool = kv.pools["layers"][name]
    if mode == "nan":
        assert torch.isnan(pool[:, 3]).all() and not torch.isnan(pool[:, :3]).any()
    with pytest.raises(ValueError, match="no corruptible"):
        rel.corrupt_kv_block(kv, 99)


# ------------------------------------------------------------ fail-points --
def test_failpoint_semantics():
    maybe_fail("nowhere")  # unarmed: a no-op
    with failpoint("a", count=2):
        for _ in range(2):
            with pytest.raises(InjectedFault, match="injected fault at 'a'"):
                maybe_fail("a")
        maybe_fail("a")  # spent
        maybe_fail("b")  # another name
        with pytest.raises(ValueError, match="already armed"):
            with failpoint("a"):
                pass
    maybe_fail("a")  # disarmed on exit
    err = OSError("disk")
    with failpoint("x", exc=err), pytest.raises(OSError) as info:
        maybe_fail("x")
    assert info.value is err
    with failpoint("x", exc=KeyError), pytest.raises(KeyError):
        maybe_fail("x")
    with failpoint("x", exc=lambda: RuntimeError("made")), pytest.raises(RuntimeError, match="made"):
        maybe_fail("x")


def test_failpoint_trips_count_times_under_threads():
    """Many threads at one armed site: exactly ``count`` of them raise."""
    import sys
    trips, lock = [0], threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with failpoint("hot", count=7):
            def work():
                for _ in range(200):
                    try:
                        maybe_fail("hot")
                    except InjectedFault:
                        with lock:
                            trips[0] += 1
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert trips[0] == 7


@settings(max_examples=15, deadline=None)
@given(num_blocks=st.integers(4, 24), seed=st.integers(0, 10_000), fail_at=st.integers(1, 6))
def test_allocator_invariants_under_injected_failures(num_blocks, seed, fail_at):
    """Random alloc/free interleavings with alloc or free raising at an
    injected point: the partition of blocks 1..nb-1 survives every crash."""
    rng = np.random.default_rng(seed)
    alloc = BlockAllocator(num_blocks)
    held = []

    def check():
        free, used = set(alloc._free), set(alloc._allocated)
        assert not (free & used)
        assert free | used == set(range(1, num_blocks))
        assert BlockAllocator.NULL_BLOCK not in free | used
        assert {b for blocks in held for b in blocks} == used

    name = "kv.alloc" if rng.integers(2) else "kv.free"
    with failpoint(name, exc=InjectedFault("chaos"), count=int(fail_at)):
        for _ in range(30):
            try:
                if rng.integers(2) and alloc.num_free:
                    got = alloc.alloc(int(rng.integers(1, alloc.num_free + 1)))
                    if got is not None:
                        held.append(got)
                elif held:
                    i = int(rng.integers(len(held)))
                    alloc.free(held[i])  # atomic: a raise leaves it ours
                    held.pop(i)
            except InjectedFault:
                pass
            check()


# ------------------------------------------------------------ checkpoints --
def test_checkpoint_crc_names_corrupt_leaf(tmp_path):
    tree = {"a": torch.arange(16, dtype=torch.float32), "b": torch.ones((4, 4), dtype=torch.bfloat16)}
    path = str(tmp_path / "ck")
    save_pytree(path, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        victim = next(os.path.join(path, e["file"]) for e in json.load(f)["leaves"] if "b" in e["path"])
    blob = bytearray(open(victim, "rb").read())
    blob[-1] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="integrity failure at leaf .*b"):
        restore_pytree(path, {k: torch.zeros_like(v) for k, v in tree.items()})
    save_pytree(str(tmp_path / "ck2"), tree)
    got = restore_pytree(str(tmp_path / "ck2"), {k: torch.zeros_like(v) for k, v in tree.items()})
    assert all(torch.equal(got[k], tree[k]) for k in tree)


@pytest.mark.parametrize("name", ["checkpoint.save.mid_write", "checkpoint.save.pre_rename"])
def test_checkpoint_mid_save_crash_is_atomic(tmp_path, name):
    """A save killed between leaf writes (on the writer threads) or before
    the rename leaves the previous step restorable and only an orphan that
    a new manager collects; the manager's own save surfaces the fault."""
    tree = {f"w{i}": torch.arange(8, dtype=torch.float32) + i for i in range(12)}
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, tree, blocking=True)
    with failpoint(name, exc=InjectedFault(name)):
        with pytest.raises(InjectedFault):
            save_pytree(mgr._step_path(2), tree)
    assert mgr.latest_step() == 1
    orphans = [n for n in os.listdir(tmp_path) if ".tmp-" in n]
    assert len(orphans) == 1
    if name.endswith("mid_write"):  # the manifest was never written
        assert not os.path.exists(os.path.join(tmp_path, orphans[0], "manifest.json"))
    with failpoint(name), pytest.raises(RuntimeError, match="checkpoint save failed") as info:
        mgr.save(3, tree, blocking=True)
    assert isinstance(info.value.__cause__, InjectedFault) and mgr.latest_step() == 1
    restored, meta = mgr.restore({k: torch.zeros_like(v) for k, v in tree.items()})
    assert meta["step"] == 1 and all(torch.equal(restored[k], tree[k]) for k in tree)
    CheckpointManager(str(tmp_path), keep=5)
    assert not [n for n in os.listdir(tmp_path) if ".tmp-" in n]


def test_mid_write_crash_spares_the_first_leaf(tmp_path):
    """``mid_write`` never trips on leaf 0: a one-leaf tree saves."""
    with failpoint("checkpoint.save.mid_write"):
        save_pytree(str(tmp_path / "one"), {"a": torch.ones(3)})
    assert os.path.exists(tmp_path / "one" / "manifest.json")


def test_reference_checkpoint_with_checksums_restores(tmp_path):
    """A reference checkpoint of checksum-stamped DiP params restores into
    the port's weights (which have none): each gets the reference's
    checksum, under the reference's paths, and it verifies the port's
    dispatch clean."""
    from repro.checkpoint.manager import save_pytree as ref_save

    r = np.random.default_rng(2)
    wn = r.normal(0, 1, (70, 40)).astype(np.float32)
    ref_tree = {"params": {"w": ref_rel.attach_checksums(ref_api.DipWeight.from_natural(jnp.asarray(wn))),
                           "b": jnp.ones(3)}, "step": jnp.asarray(2, jnp.int32)}
    ref_save(str(tmp_path / "ck"), ref_tree)
    like = {"params": {"w": api.DipWeight.from_natural(torch.zeros(70, 40)), "b": torch.zeros(3)}, "step": 0}
    got = restore_pytree(str(tmp_path / "ck"), like)
    w = got["params"]["w"]
    assert [p for p, _ in tree_lib.paths(got)] == ["['params']/['b']", "['params']/['w']/.data",
                                                   "['params']/['w']/.checksum/.col",
                                                   "['params']/['w']/.checksum/.row",
                                                   "['params']/['w']/.checksum/.row_abs", "['step']"]
    for f in ("col", "row", "row_abs"):
        assert np.array_equal(getattr(w.checksum, f).numpy(), np.asarray(getattr(ref_tree["params"]["w"].checksum, f)))
    x = torch.from_numpy(r.normal(0, 1, (4, 70)).astype(np.float32))
    assert bool(api.matmul(x, w, backend="dip", verify=True)[1]["ok"]) and got["step"] == 2
    # and the port writes them back under the same paths
    save_pytree(str(tmp_path / "again"), got)
    again = restore_pytree(str(tmp_path / "again"), {"params": {"w": api.DipWeight.from_natural(torch.zeros(70, 40)),
                                                                "b": torch.zeros(3)}, "step": 0})
    assert torch.equal(again["params"]["w"].checksum.row_abs, w.checksum.row_abs)
