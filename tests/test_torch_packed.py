"""The port's packed formats, spmm plain version and checkpoints vs the
reference's, on shared numpy inputs.

* Packing (``pack_nm``/``pack_gathered``/``unpack``/``mask_of``/
  ``infer_nm``/``representable``) is bitwise equal to the reference —
  values, indices and their dtypes — and raises the same ``ValueError``
  on the same bad masks.
* ``spmm_plain`` (the CPU path of ``ops.spmm``) vs the reference's
  ``spmm(..., kernel="jnp")`` in the decode (T < 16) and prefill (T >= 16)
  regimes, both formats, every epilogue, with and without bias: within
  1e-5 of max|y| (fp32 sums in another order). Two small cases against
  ``kernel="pallas"`` in interpret mode.
* Masks-tree checkpoints cross-read both ways (fp32, int32, uint8; bf16
  leaves bitwise), and a corrupt shard is rejected.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro import ckpt as jckpt  # noqa: E402
from repro.core import masks as jmasks  # noqa: E402
from repro.core import packed as jpacked  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import spmm as jspmm  # noqa: E402

from repro_torch import ckpt as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import packed as tpacked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import spmm as tspmm  # noqa: E402

ARCH = "llama31-8b"


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mask(seed, shape, pattern):
    """A numpy mask made by the reference's ``make_mask``."""
    return np.array(jmasks.make_mask(jnp.asarray(_rand(seed + 999, shape)),
                                       pattern), dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _np(x):
    """Reference or port array -> numpy, bf16 as float32 (exact)."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _same_packing(got: tpacked.PackedWeight, want):
    assert (got.fmt, got.d_in, got.n, got.m) == \
        (want.fmt, want.d_in, want.n, want.m)
    assert got.idx.numpy().dtype == np.asarray(want.idx).dtype
    assert np.array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert np.array_equal(_np(got.values), _np(want.values))
    assert got.nbytes == want.nbytes and got.dense_nbytes == want.dense_nbytes


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,nm", [((5, 16), (2, 4)), ((3, 7, 24), (4, 8)),
                                      ((2, 9, 8), (1, 4))])
def test_pack_nm_bitwise_equal(shape, nm, dtype):
    seed = sum(shape) + nm[1]
    w, mk = _rand(seed, shape), _mask(seed, shape, jmasks.NM(*nm))
    want = jpacked.pack_nm(jnp.asarray(w).astype(dtype), jnp.asarray(mk),
                           n=nm[0], m=nm[1])
    tw = _t(w).to(getattr(torch, dtype))
    got = tpacked.pack_nm(tw, _t(mk), n=nm[0], m=nm[1])
    _same_packing(got, want)
    assert np.array_equal(_np(tpacked.unpack(got)),
                          _np(jpacked.unpack(want)))
    assert np.array_equal(_np(tpacked.unpack(got)), _np(tw * _t(mk).to(tw.dtype)))
    assert np.array_equal(tpacked.mask_of(got).numpy(),
                          np.asarray(jpacked.mask_of(want)))
    assert tpacked.infer_nm(_t(mk)) == jpacked.infer_nm(mk) == nm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,sparsity", [((6, 20), 0.25), ((2, 5, 33), 0.6),
                                            ((4, 16), 0.5)])
def test_pack_gathered_bitwise_equal(shape, sparsity, dtype):
    seed = sum(shape)
    w = _rand(seed, shape)
    mk = _mask(seed, shape, jmasks.PerRow(sparsity))
    want = jpacked.pack_gathered(jnp.asarray(w).astype(dtype), jnp.asarray(mk))
    got = tpacked.pack_gathered(_t(w).to(getattr(torch, dtype)), _t(mk))
    _same_packing(got, want)
    assert np.array_equal(_np(tpacked.unpack(got)),
                          _np(jpacked.unpack(want)))
    assert np.array_equal(tpacked.mask_of(got).numpy(),
                          np.asarray(jpacked.mask_of(want)))
    assert tpacked.pack(_t(w), _t(mk), "gathered").k == want.k


def _bad_masks():
    ok24 = _mask(1, (4, 8), jmasks.NM(2, 4))
    three = ok24.copy()
    three[0, :4] = 1.0                                    # a 4:4 block
    half = ok24 * 0.5                                     # not 0/1
    uneven = _mask(2, (4, 8), jmasks.PerRow(0.5))
    uneven[1, :] = 1.0                                    # unequal rows
    return [("nm24", three), ("nm24", half), ("gathered", uneven),
            ("gathered", np.zeros((3, 8), np.float32)),    # all pruned
            ("csr", ok24), ("nm24", np.ones((2, 6), np.float32))]


@pytest.mark.parametrize("case", range(6))
def test_pack_rejects_what_the_reference_rejects(case):
    fmt, mk = _bad_masks()[case]
    w = _rand(case, mk.shape)
    with pytest.raises(ValueError) as want:
        jpacked.pack(jnp.asarray(w), jnp.asarray(mk), fmt)
    with pytest.raises(ValueError) as got:
        tpacked.pack(_t(w), _t(mk), fmt)
    assert str(got.value) == str(want.value)


def test_infer_nm_and_representable():
    cfg_j, cfg_t = jconfigs.get_tiny(ARCH), tconfigs.get_tiny(ARCH)
    shapes = {"wq": (2, 64, 64), "w_down": (2, 64, 96)}

    def tree(pattern, seed):
        return {"layers": {
            "attn": {"wq": _mask(seed, shapes["wq"], pattern)},
            "mlp": {"w_down": _mask(seed + 1, shapes["w_down"], pattern)}}}

    for masks in (tree(jmasks.NM(2, 4), 0), tree(jmasks.PerRow(0.6), 3),
                  tree(jmasks.NM(1, 4), 5)):
        tmasks_tree = convert.from_numpy(masks)
        for fmt in ("nm24", "gathered"):
            assert tpacked.representable(cfg_t, tmasks_tree, fmt) == \
                jpacked.representable(cfg_j, masks, fmt)
    uneven = tree(jmasks.PerRow(0.6), 7)
    uneven["layers"]["attn"]["wq"][0, 0, :] = 1.0
    assert not tpacked.representable(cfg_t, convert.from_numpy(uneven),
                                     "gathered")
    assert not jpacked.representable(cfg_j, uneven, "gathered")
    with pytest.raises(ValueError, match="not N:M"):
        tpacked.infer_nm(_t(uneven["layers"]["attn"]["wq"]))
    with pytest.raises(ValueError, match="unknown packed format"):
        tpacked.representable(cfg_t, convert.from_numpy(uneven), "csr")


def test_pack_tree_names_the_site_and_keeps_params():
    cfg = tconfigs.get_tiny(ARCH)
    w = torch.from_numpy(_rand(0, (2, 64, 64)))
    params = {"layers": {"attn": {"wq": w}}}
    masks = {"layers": {"attn": {"wq": _t(_mask(0, (2, 64, 64),
                                                 jmasks.PerRow(0.6)))}}}
    with pytest.raises(ValueError, match="layers.attn.wq"):
        tpacked.pack_tree(cfg, params, masks, "nm24")
    out = tpacked.pack_tree(cfg, params, masks, "gathered")
    assert isinstance(out["layers"]["attn"]["wq"], tpacked.PackedWeight)
    assert params["layers"]["attn"]["wq"] is w            # input untouched
    assert tpacked.packed_bytes(out) == out["layers"]["attn"]["wq"].nbytes


def test_convert_carries_a_reference_packed_weight():
    w, mk = _rand(4, (2, 6, 16)), _mask(4, (2, 6, 16), jmasks.NM(2, 4))
    jpw = jax.tree.map(np.asarray, jpacked.pack_nm(jnp.asarray(w),
                                                   jnp.asarray(mk)),
                       is_leaf=lambda x: isinstance(x, jax.Array))
    got = convert.from_numpy({"layers": {"mlp": {"w_up": jpw}}})
    _same_packing(got["layers"]["mlp"]["w_up"], jpw)


# ---------------------------------------------------------------------------
# spmm plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["nm24", "gathered"])
@pytest.mark.parametrize("T", [3, 20])
def test_spmm_plain_matches_reference(fmt, T):
    d_out, d_in = 12, 32
    w = _rand(T, (d_out, d_in))
    mk = _mask(T, (d_out, d_in),
               jmasks.NM(2, 4) if fmt == "nm24" else jmasks.PerRow(0.6))
    x = _rand(T + 1, (2, T, d_in))
    bias = _rand(T + 2, (d_out,))
    jpw = jpacked.pack(jnp.asarray(w), jnp.asarray(mk), fmt)
    tpw = tpacked.pack(_t(w), _t(mk), fmt)
    for act in (None, *jspmm.EPILOGUES):
        assert act is None or act in tspmm.EPILOGUES
        for b in (None, bias):
            want = np.asarray(jspmm.spmm(
                jnp.asarray(x), jpw, kernel="jnp",
                bias=None if b is None else jnp.asarray(b), act=act))
            got = ops.spmm(_t(x), tpw, bias=None if b is None else _t(b),
                           act=act).numpy()
            assert got.shape == (2, T, d_out)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(
                1.0, np.abs(want).max()), err_msg=f"{act} bias={b is not None}")
    assert ops.LAUNCHES["spmm"] == 0               # the CPU took the plain version
    dense = ref.masked_matmul_ref(_t(x[0]), _t(w), _t(mk)).numpy()
    np.testing.assert_allclose(
        dense, np.asarray(jref.masked_matmul_ref(jnp.asarray(x[0]),
                                                 jnp.asarray(w),
                                                 jnp.asarray(mk))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fmt,act", [("nm24", "silu"), ("gathered", "relu2")])
def test_spmm_plain_matches_reference_pallas_interpret(fmt, act):
    w = _rand(7, (6, 16))
    mk = _mask(7, (6, 16),
               jmasks.NM(2, 4) if fmt == "nm24" else jmasks.PerRow(0.5))
    x, bias = _rand(8, (3, 16)), _rand(9, (6,))
    jpw = jpacked.pack(jnp.asarray(w), jnp.asarray(mk), fmt)
    want = np.asarray(jspmm.spmm(jnp.asarray(x), jpw, kernel="pallas",
                                 bias=jnp.asarray(bias), act=act))
    got = ops.spmm(_t(x), tpacked.pack(_t(w), _t(mk), fmt), bias=_t(bias),
                   act=act).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_spmm_wrappers_and_bf16_cast():
    w, mk = _rand(1, (8, 16)), _mask(1, (8, 16), jmasks.NM(2, 4))
    pw = tpacked.pack(_t(w), _t(mk), "nm24")
    x = _t(_rand(2, (5, 16)))
    y = ops.spmm(x, pw)
    assert torch.equal(ops.spmm_nm24(x, pw.values, pw.idx), y)
    gw = tpacked.pack(_t(w), _t(mk), "gathered")
    assert torch.equal(ops.spmm_gather(x, gw.values, gw.idx, d_in=16), y)
    yb = ops.spmm(x.to(torch.bfloat16), pw)             # one cast at the end
    assert yb.dtype == torch.bfloat16
    assert torch.equal(yb, tspmm.spmm_plain(x.to(torch.bfloat16), pw))


def test_spmm_rejects_bad_input():
    w, mk = _rand(3, (2, 4, 16)), _mask(3, (2, 4, 16), jmasks.NM(2, 4))
    stacked = tpacked.pack(_t(w), _t(mk), "nm24")
    x = torch.zeros(3, 16)
    with pytest.raises(ValueError, match="unstacked"):
        ops.spmm(x, stacked)
    pw = tpacked.pack(_t(w[0]), _t(mk[0]), "nm24")
    with pytest.raises(ValueError, match="features"):
        ops.spmm(torch.zeros(3, 12), pw)
    with pytest.raises(ValueError, match="epilogue"):
        ops.spmm(x, pw, act="tanh")
    with pytest.raises(ValueError, match="bias"):
        ops.spmm(x, pw, bias=torch.zeros(5))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _tree():
    rng = np.random.default_rng(0)
    return {"layers": {"attn": {"wq": rng.normal(size=(2, 4, 8)).astype(np.float32)},
                       "mlp": {"idx": rng.integers(0, 9, (3, 5)).astype(np.int32)}},
            "meta": rng.integers(0, 255, (7,)).astype(np.uint8),
            "scalar": np.float32(2.5)}


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_ckpt_reference_writes_port_reads(tmp_path):
    tree = _tree()
    jckpt.save(tmp_path, 3, jax.tree.map(jnp.asarray, tree))
    assert tckpt.steps(tmp_path) == [3] and tckpt.latest_valid(tmp_path) == 3
    got, man = tckpt.restore(tmp_path, 3)
    assert man["step"] == 3
    want = dict(_flat(tree))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_ckpt_port_writes_reference_reads(tmp_path):
    tree = _tree()
    port_tree = {"layers": convert.from_numpy(tree["layers"]),
                 "meta": torch.from_numpy(tree["meta"]),
                 "scalar": tree["scalar"]}
    tckpt.save(tmp_path, 0, port_tree, extra={"who": "port"})
    assert jckpt.latest_valid(tmp_path) == 0
    man = json.loads((tmp_path / "step_00000000" / "MANIFEST.json").read_text())
    assert man["extra"] == {"who": "port"}
    target = {e["path"]: jax.ShapeDtypeStruct(tuple(e["shape"]), e["dtype"])
              for e in man["leaves"]}
    got, _ = jckpt.restore(tmp_path, 0, target)
    for k, v in _flat(tree):
        assert np.asarray(got[k]).dtype == v.dtype
        assert np.array_equal(np.asarray(got[k]), v), k
    # and the reference's own masks-tree loader reads the port's masks
    jcfg = jconfigs.get_tiny(ARCH)
    mk = _mask(0, (2, 64, 64), jmasks.NM(2, 4))
    tckpt.save(tmp_path / "m", 0, {"layers": {"attn": {"wq": _t(mk)}}})
    jt = jpacked.load_mask_tree(jcfg, {}, tmp_path / "m")
    assert np.array_equal(np.asarray(jt["layers"]["attn"]["wq"]), mk)


def test_ckpt_rejects_corruption_and_bf16(tmp_path):
    tckpt.save(tmp_path, 1, {"a": torch.ones(4)})
    tckpt.save(tmp_path, 2, {"a": torch.zeros(4)})
    d = tmp_path / "step_00000002"
    man = json.loads((d / "MANIFEST.json").read_text())
    man["leaves"][0]["shards"][0]["sha256"] = "0" * 64
    (d / "MANIFEST.json").write_text(json.dumps(man))
    assert not tckpt.validate(d) and not jckpt.validate(d)
    assert tckpt.latest_valid(tmp_path) == 1            # skips the corrupt one
    with pytest.raises(IOError, match="hash mismatch"):
        tckpt.restore(tmp_path, 2)
    # bf16 leaves are written byte for byte as the reference writes them
    # (raw 2-byte records, dtype "bfloat16") and read back bitwise
    b = torch.tensor([1.5, -2.25, 3e-3], dtype=torch.bfloat16)
    tckpt.save(tmp_path, 3, {"a": b})
    jckpt.save(tmp_path / "ref", 3, {"a": jax.numpy.asarray(
        b.float().numpy()).astype(jax.numpy.bfloat16)})
    leaf = lambda d: json.loads((d / "step_00000003" / "MANIFEST.json")
                                .read_text())["leaves"][0]
    mine, theirs = leaf(tmp_path), leaf(tmp_path / "ref")
    assert mine["dtype"] == theirs["dtype"] == "bfloat16"
    assert mine["shards"][0]["sha256"] == theirs["shards"][0]["sha256"]
    for d in (tmp_path, tmp_path / "ref"):
        got = tckpt.to_tensor(tckpt.restore(d, 3)[0]["a"])
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), b.view(torch.int16))
    assert tckpt.steps(tmp_path) == [1, 2, 3]            # nothing half-written


# shard index slices of an (8, 6) leaf, as the reference's manifest
# records them ([start, stop], stop -1 for "to the end"): one shard that is
# the whole leaf (the layout both packages write from one process), and
# the layouts of a leaf sharded over a mesh
SHARD_LAYOUTS = {
    "one_shard": [[[0, -1], [0, -1]]],
    "one_shard_explicit_stops": [[[0, 8], [0, 6]]],
    "rows_4": [[[2 * i, 2 * i + 2], [0, -1]] for i in range(4)],
    "rows_2_cols_3": [[[r, r + 4], [c, c + 2]] for r in (0, 4)
                      for c in (0, 2, 4)],
}


@pytest.mark.parametrize("layout", sorted(SHARD_LAYOUTS))
def test_ckpt_restores_each_shard_layout(tmp_path, layout):
    """A leaf written as one shard or as many (in the reference's on-disk
    layout: shard files, keys, index slices, a sha256 a shard) is read back
    bitwise by ``validate`` and ``restore`` in both packages, beside a
    one-shard leaf; a shard with a wrong hash fails both reads."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(8, 6)).astype(np.float32)
    b = rng.integers(-9, 9, (5,)).astype(np.int32)
    d = tmp_path / "step_00000004"
    d.mkdir()
    files: dict[str, dict] = {}
    leaves = []
    for name, arr, index in (("b", b, [[[0, -1]]]),
                             ("w", w, SHARD_LAYOUTS[layout])):
        entry = {"path": name, "shape": list(arr.shape),
                 "dtype": str(arr.dtype), "shards": []}
        for k, idx in enumerate(index):
            part = np.ascontiguousarray(arr[tuple(
                slice(a, n if e == -1 else e)
                for (a, e), n in zip(idx, arr.shape))])
            fname = f"shard_0_{k % 2}.npz"
            files.setdefault(fname, {})[f"{name}__{k}"] = part
            entry["shards"].append({
                "file": fname, "key": f"{name}__{k}", "index": idx,
                "sha256": jckpt.store._sha256(part)})
        leaves.append(entry)
    for fname, bufs in files.items():
        np.savez(d / fname, **bufs)
    man = {"step": 4, "time": 0.0, "extra": {}, "leaves": leaves}
    (d / "MANIFEST.json").write_text(json.dumps(man))

    assert tckpt.validate(d) and jckpt.validate(d)
    got, _ = tckpt.restore(tmp_path, 4)
    ref, _ = jckpt.restore(tmp_path, 4, {
        "b": jax.ShapeDtypeStruct(b.shape, b.dtype),
        "w": jax.ShapeDtypeStruct(w.shape, w.dtype)})
    for name, want in (("b", b), ("w", w)):
        assert got[name].dtype == want.dtype, name
        assert np.array_equal(got[name], want), name
        assert np.array_equal(got[name], np.asarray(ref[name])), name
    only_w, _ = tckpt.restore(tmp_path, 4, paths=["w"])
    assert list(only_w) == ["w"] and np.array_equal(only_w["w"], w)

    # a wrong hash on the leaf's last shard fails both reads
    leaves[1]["shards"][-1]["sha256"] = "0" * 64
    (d / "MANIFEST.json").write_text(json.dumps(man))
    assert not tckpt.validate(d) and not jckpt.validate(d)
    assert tckpt.latest_valid(tmp_path) is None
    with pytest.raises(IOError, match="hash mismatch"):
        tckpt.restore(tmp_path, 4)
