"""The port's HDF5 layer (``common/h5.py``) against h5py: files h5py
writes read back equal through ``h5.File``, files ``h5.File`` writes read
back equal through h5py (the same members in the same order, the same
values, dtypes and string types), ``"a"`` keeps what it does not change
bit for bit, and the features the layer does not read raise an error that
names them."""

import json

import h5py
import numpy as np
import pytest
import torch

from oct_image_segmentation_models_torch.common import h5, model_io

DTYPES = ["u1", "u2", "i4", "i8", "f4", "f8", ">f4", "bool"]
SHAPES = [(), (0, 3), (7,), (2, 3, 4, 5)]


def _values(dtype, shape, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.standard_normal(shape) * 100).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape, dtype=dt, endpoint=True)


def _value(v):
    """A comparable form of a value as h5py or the layer returns it:
    its Python type, dtype, shape and bytes (or items)."""
    if isinstance(v, np.ndarray):
        body = v.tolist() if v.dtype.kind == "O" else v.tobytes()
        return ("ndarray", v.dtype.str, v.shape, body)
    if isinstance(v, np.generic):
        return (type(v).__name__, v.dtype.str, v.tobytes())
    if isinstance(v, (h5py.Empty, h5.Empty)):
        return ("Empty", np.dtype(v.dtype).str)
    return (type(v).__name__, v)


def _string_type(tid):
    """The HDF5 string type behind an h5py dtype: (variable, padding,
    character set), or None for other types."""
    if tid.get_class() != h5py.h5t.STRING:
        return None
    return (tid.is_variable_str(), tid.get_strpad(), tid.get_cset(), tid.get_size())


def describe(obj, low_level=False):
    """Members, values, dtypes and attributes of an h5py or ``h5``
    object, in iteration order. ``low_level`` (h5py only) adds the
    HDF5 string types."""
    attrs = []
    for key in obj.attrs.keys():
        entry = (key, _value(obj.attrs[key]))
        if low_level:
            entry += (_string_type(obj.attrs.get_id(key).get_type()),)
        attrs.append(entry)
    if isinstance(obj, (h5py.Dataset, h5.Dataset)):
        out = ("dataset", obj.shape, obj.dtype.str, _value(obj[()]), attrs)
        if low_level:
            out += (_string_type(obj.id.get_type()),)
        return out
    return ("group", attrs, [(k, describe(obj[k], low_level)) for k in obj.keys()])


# ---------------------------------------------------------------------------
# Trees written through the common API of h5py and the layer
# ---------------------------------------------------------------------------


def _numeric(dtype, shape):
    def build(f):
        f.create_dataset("data", data=_values(dtype, shape))
        f.attrs["attr"] = _values(dtype, shape, seed=1)
        f["by_setitem"] = _values(dtype, shape, seed=2)
    return build


def _strings(f):
    f.attrs["s1"] = np.array("a", dtype="S1")
    f.attrs["s100"] = np.array("timestamp 2026", dtype="S100")
    f.attrs["s1000"] = np.array("x" * 999, dtype="S1000")
    f.attrs["bytes"] = np.bytes_("tensorflow")
    f.attrs["s_array"] = np.array([b"conv2d", b"batch_normalization_12"], dtype="S22")
    f.attrs["vlen"] = "variable-length é"
    f.attrs["vlen_empty"] = ""
    f.attrs["vlen_list"] = ["layer_a", "", "layer_ccc"]
    f.attrs["ünicode name"] = 3
    f.create_dataset("names", data=["image_0.png", "b"], dtype="S1000")
    f.create_dataset("name", data=np.bytes_("one"))
    f["vlen_ds"] = "a variable-length dataset"
    f["empty_s"] = np.zeros((0,), "S5")


def _nested(f):
    g = f.create_group("params")
    g.attrs["level"] = 1
    g.create_group("ConvBlock_0/Conv_0").create_dataset("kernel", data=np.ones((3, 3, 1, 2), "f4"))
    g["ConvBlock_0/BatchNorm_0/scale"] = np.arange(2, dtype="f4")
    f.create_group("empty_group")
    f["params/ConvBlock_0"].attrs["x"] = np.array([1.5, 2.5])


def _wide(f):
    g = f.create_group("wide")
    for i in range(300):
        g[f"member_{(i * 7919) % 300:03d}"] = np.array([i], "i4")


def _many_attrs(f):
    for i in range(60):
        f.attrs[f"attr_{i:02d}"] = np.array(f"{i}" * (1000 // len(str(i))), dtype="S1000")
    f["d"] = np.arange(5)
    for i in range(40):
        f["d"].attrs[f"a{i}"] = float(i)


def _bools(f):
    f.attrs["t"] = True
    f.attrs["f"] = np.bool_(False)
    f.attrs["arr"] = np.array([True, False, True])
    f["flags"] = np.array([[True], [False]])


def _keras_layout(f):
    names = [f"layer_with_a_long_name_{i:05d}".encode() for i in range(3000)]
    half = len(names) // 2  # Keras splits attributes past 64 KB
    f.attrs["layer_names0"] = np.array(names[:half])
    f.attrs["layer_names1"] = np.array(names[half:])
    f.attrs["keras_version"] = "2.9.0"
    f.attrs["backend"] = "tensorflow"
    f.attrs["model_config"] = json.dumps({"class_name": "Functional", "config": {"name": "unet"}})
    grp = f.create_group("conv2d")
    grp.attrs["weight_names"] = np.array([b"conv2d/kernel:0", b"conv2d/bias:0"])
    grp.create_group("conv2d").create_dataset("kernel:0", data=np.ones((3, 3, 1, 4), "f4"))
    grp["conv2d/bias:0"] = np.zeros(4, "f4")


TREES = {
    **{f"{d}-{'x'.join(map(str, s)) or 'scalar'}": _numeric(d, s) for d in DTYPES for s in SHAPES},
    "strings": _strings,
    "nested": _nested,
    "wide_group": _wide,
    "many_attributes": _many_attrs,
    "bools": _bools,
    "keras_layout": _keras_layout,
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_layer_reads_what_h5py_writes(tmp_path, name):
    path = tmp_path / "h5py.h5"
    with h5py.File(path, "w") as f:
        TREES[name](f)
    with h5py.File(path, "r") as f:
        expected = describe(f)
    with h5.File(path, "r") as f:
        assert describe(f) == expected


@pytest.mark.parametrize("name", sorted(TREES))
def test_h5py_reads_what_the_layer_writes(tmp_path, name):
    with h5py.File(tmp_path / "h5py.h5", "w") as f:
        TREES[name](f)
    with h5py.File(tmp_path / "h5py.h5", "r") as f:
        expected = describe(f, low_level=True)
    path = tmp_path / "layer.h5"
    with h5.File(path, "w") as f:
        TREES[name](f)
    with h5py.File(path, "r") as f:
        assert describe(f, low_level=True) == expected
    with h5.File(path, "r") as f:
        assert describe(f) == describe(h5py.File(path, "r"))


def test_written_file_ends_at_its_eof_address(tmp_path):
    path = tmp_path / "f.h5"
    with h5.File(path, "w") as f:
        _nested(f)
    raw = path.read_bytes()
    assert raw[:8] == h5.SIGNATURE and raw[8] == 0  # superblock v0
    assert int.from_bytes(raw[40:48], "little") == len(raw)


def test_h5py_can_add_to_a_written_group(tmp_path):
    path = tmp_path / "f.h5"
    with h5.File(path, "w") as f:
        _wide(f)
    with h5py.File(path, "a") as f:
        for i in range(40):
            f[f"wide/added_{i}"] = np.array([i])
    with h5py.File(path, "r") as f:
        assert len(f["wide"]) == 340
        assert f["wide/member_123"][0] == [i for i in range(300) if (i * 7919) % 300 == 123][0]


# ---------------------------------------------------------------------------
# Storage that only h5py writes: chunks and filters, user blocks, v2 headers
# ---------------------------------------------------------------------------


def _chunked(f):
    data = _values("i4", (11, 6, 5))
    f.create_dataset("gzip_shuffle", data=data, chunks=(3, 4, 5), compression="gzip",
                     compression_opts=6, shuffle=True)
    f.create_dataset("gzip", data=_values("f8", (9, 4)), chunks=(2, 3), compression="gzip")
    f.create_dataset("shuffle", data=_values("u2", (10,)), chunks=(4,), shuffle=True)
    f.create_dataset("plain_chunks", data=_values("u1", (5, 7)), chunks=(2, 2))
    f.create_dataset("partly_written", shape=(8, 3), dtype="f4", chunks=(2, 3), fillvalue=-1.5)
    f["partly_written"][2:4] = 7.0


STORAGE = {
    "plain": {}, "userblock512": {"userblock_size": 512},
    "userblock1024": {"userblock_size": 1024}, "libver-latest": {"libver": "latest"},
}


@pytest.mark.parametrize("storage,name", [
    (storage, name)
    for storage in STORAGE
    for name in ["chunked", "strings", "nested", "bools", "f8-2x3x4x5"]
    # "strings" puts 9 attributes on the root: dense storage in a v2 file
    if (storage, name) != ("libver-latest", "strings")
])
def test_layer_reads_h5py_storage_options(tmp_path, storage, name):
    kwargs = STORAGE[storage]
    build = _chunked if name == "chunked" else TREES[name]
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", **kwargs) as f:
        if kwargs.get("libver") == "latest" and name == "chunked":
            # v2 files index chunks with structures the layer refuses;
            # a compact dataset stands in for them
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            space = h5py.h5s.create_simple((6,))
            h5py.h5d.create(f.id, b"compact", h5py.h5t.STD_I16LE, space, dcpl=dcpl).write(
                h5py.h5s.ALL, h5py.h5s.ALL, np.arange(6, dtype="<i2")
            )
        else:
            build(f)
    with h5py.File(path, "r") as f:
        expected = describe(f)
    with h5.File(path, "r") as f:
        assert describe(f) == expected


def test_layer_reads_compact_datasets(tmp_path):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        data = np.arange(12, dtype="<f4").reshape(4, 3)
        h5py.h5d.create(f.id, b"compact", h5py.h5t.IEEE_F32LE, h5py.h5s.create_simple((4, 3)),
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, data)
    with h5.File(path, "r") as f:
        np.testing.assert_array_equal(f["compact"][()], data)
        np.testing.assert_array_equal(f["compact"][1::2, 1:], data[1::2, 1:])


KEYS = [
    (), slice(None), slice(1, None, 3), slice(2, 9, 4), slice(0, 5), 3, -1,
    (slice(0, None, 2), 1), (slice(None), Ellipsis, 0), Ellipsis,
]


@pytest.mark.parametrize("key", KEYS, ids=repr)
@pytest.mark.parametrize("dataset", ["contiguous", "gzip_shuffle", "plain_chunks", "partly_written"])
def test_strided_and_indexed_reads(tmp_path, dataset, key):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w") as f:
        _chunked(f)
        f["contiguous"] = _values("i8", (10, 3, 2))
    with h5py.File(path, "r") as f:
        expected = f[dataset][key]
    with h5.File(path, "r") as f:
        got = f[dataset][key]
    assert _value(got) == _value(expected)


def test_strided_read_reads_only_its_rows(tmp_path):
    path = tmp_path / "f.h5"
    rows = np.arange(12, dtype="u1")[:, None, None] * np.ones((1, 64, 64), "u1")
    with h5.File(path, "w") as f:
        f["images"] = rows
    with h5.File(path, "r") as f:
        fh = f._reader.fh
        seen = []
        real_readinto = fh.readinto

        def readinto(buf):
            seen.append((fh.tell(), len(buf)))
            return real_readinto(buf)

        fh.readinto = readinto
        shard = f["images"][1::4]
    assert shard[:, 0, 0].tolist() == [1, 5, 9]
    assert len(seen) == 3 and all(size == 64 * 64 for _, size in seen)


# ---------------------------------------------------------------------------
# "a": the rest stays bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["h5py", "layer"])
def test_append_adds_an_attribute_and_keeps_the_rest(tmp_path, writer):
    path = tmp_path / "f.h5"
    opener = h5py.File if writer == "h5py" else h5.File
    with opener(path, "w") as f:
        _strings(f)
        _bools(f)
        _numeric(">f4", (2, 3, 4, 5))(f.create_group("numbers"))
        _many_attrs(f.create_group("attrs"))
    with h5py.File(path, "r") as f:
        before = describe(f, low_level=True)
    with h5.File(path, "a") as f:
        f.attrs["bn_precise_stats_applied"] = True
    with h5py.File(path, "r") as f:
        after = describe(f, low_level=True)
        assert f.attrs["bn_precise_stats_applied"] is np.True_ or f.attrs[
            "bn_precise_stats_applied"
        ] == np.bool_(True)
    added = [a for a in after[1] if a[0] == "bn_precise_stats_applied"]
    assert added == [("bn_precise_stats_applied", _value(np.bool_(True)), None)]
    assert [a for a in after[1] if a[0] != "bn_precise_stats_applied"] == before[1]
    assert after[2] == before[2]
    assert not list(tmp_path.glob(".*.tmp"))


def test_append_creates_a_missing_file(tmp_path):
    path = tmp_path / "new.h5"
    with h5.File(path, "a") as f:
        f.attrs["x"] = 1
    with h5py.File(path, "r") as f:
        assert f.attrs["x"] == 1


def test_failed_write_leaves_the_previous_file(tmp_path):
    path = tmp_path / "f.h5"
    with h5.File(path, "w") as f:
        f["keep"] = np.arange(3)
    before = path.read_bytes()
    with pytest.raises(TypeError):
        with h5.File(path, "a") as f:
            f.attrs["bad"] = np.array([object()])
    f = h5.File(path, "a")
    f._children["bad"] = h5.Dataset(f, "/bad", f, h5._Value(np.array([object()]), None, (1,)))
    with pytest.raises(Exception):
        f.close()
    assert path.read_bytes() == before
    assert not list(tmp_path.glob(".*.tmp"))


def test_read_mode_refuses_writes_and_closed_files_refuse_reads(tmp_path):
    path = tmp_path / "f.h5"
    with h5.File(path, "w") as f:
        f["d"] = np.arange(3)
    f = h5.File(path, "r")
    with pytest.raises(ValueError, match="read-only"):
        f.attrs["x"] = 1
    ds = f["d"]
    f.close()
    with pytest.raises(ValueError, match="closed"):
        ds[()]
    with pytest.raises(FileNotFoundError):
        h5.File(tmp_path / "missing" / "f.h5", "w")
    with pytest.raises(h5.FormatError, match="signature"):
        (tmp_path / "not.h5").write_bytes(b"x" * 4096)
        h5.File(tmp_path / "not.h5", "r")


# ---------------------------------------------------------------------------
# Refused features
# ---------------------------------------------------------------------------


def _dense_attrs(f):
    for i in range(9):
        f.attrs[f"a{i}"] = i


def _dense_links(f):
    for i in range(9):
        f[f"d{i}"] = np.arange(2)


def _compound(f):
    f["c"] = np.zeros(3, dtype=[("a", "i4"), ("b", "f8")])


def _soft(f):
    f["d"] = np.arange(2)
    f["link"] = h5py.SoftLink("/d")


def _external(f):
    f["link"] = h5py.ExternalLink("other.h5", "/d")


def _fletcher(f):
    f.create_dataset("d", data=np.arange(10), chunks=(5,), fletcher32=True)


def _lzf(f):
    f.create_dataset("d", data=np.arange(10), chunks=(5,), compression="lzf")


def _chunked_v4(f):
    f.create_dataset("d", data=np.arange(10), chunks=(5,))


def _enum(f):
    f.create_dataset("e", data=np.array([0, 1], "u1"),
                     dtype=h5py.enum_dtype({"RED": 0, "GREEN": 1}, basetype="u1"))


def _reference(f):
    f["d"] = np.arange(2)
    f.attrs["ref"] = f["d"].ref


def _array(f):
    f.create_dataset("a", shape=(2,), dtype=np.dtype(("i4", (3,))))


def _opaque(f):
    f["o"] = np.void(b"\x01\x02")


def _vlen_seq(f):
    f.create_dataset("v", shape=(1,), dtype=h5py.vlen_dtype(np.int32))


REFUSED = {
    "dense attribute storage": (_dense_attrs, {"libver": "latest"}),
    "dense link storage": (_dense_links, {"libver": "latest"}),
    "compound datatype": (_compound, {}),
    "soft link": (_soft, {}),
    "external link": (_external, {}),
    "filter fletcher32": (_fletcher, {}),
    "filter 32000": (_lzf, {}),
    "chunked layout version 4": (_chunked_v4, {"libver": "latest"}),
    "enumeration type other than h5py's bool": (_enum, {}),
    "reference datatype": (_reference, {}),
    "array datatype": (_array, {}),
    "opaque datatype": (_opaque, {}),
    "variable-length sequence type": (_vlen_seq, {}),
}


@pytest.mark.parametrize("feature", sorted(REFUSED))
def test_unread_features_raise_and_name_themselves(tmp_path, feature):
    build, kwargs = REFUSED[feature]
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", **kwargs) as f:
        build(f)
    with pytest.raises(h5.UnsupportedFeature) as err:
        with h5.File(path, "r") as f:
            describe(f)
    assert feature in str(err.value)


def test_compact_storage_limits_read_and_refused(tmp_path):
    """At most 8 attributes and links a v2 object stays compact and
    reads; one more moves them to dense storage, which is refused."""
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(8):
            f.attrs[f"a{i}"] = i
            f.create_group(f"g{i}").attrs["x"] = np.arange(i + 1)
    with h5.File(path, "r") as f:
        assert describe(f) == describe(h5py.File(path, "r"))


def test_v2_checksums_are_verified(tmp_path):
    path = tmp_path / "f.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.attrs["marker"] = np.array("find me", dtype="S7")
    raw = bytearray(path.read_bytes())
    at = raw.index(b"find me")
    raw[at] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(h5.FormatError, match="checksum"):
        h5.File(path, "r")


def test_oversized_attribute_is_refused_on_write(tmp_path):
    with pytest.raises(h5.UnsupportedFeature, match="64 KiB"):
        with h5.File(tmp_path / "f.h5", "w") as f:
            f.attrs["big"] = np.zeros(70_000, "u1")


# ---------------------------------------------------------------------------
# The packages' checkpoints, each read by the other
# ---------------------------------------------------------------------------


def _unet_state():
    from oct_image_segmentation_models_torch.models import get_model_class

    container = get_model_class("unet")(
        input_channels=1, num_classes=3, image_height=32, image_width=32,
        start_neurons=4, pool_layers=2,
    )
    torch.manual_seed(3)
    module = container.build_model(device="cpu")
    return container.get_config(), {k: v.detach().clone() for k, v in module.state_dict().items()}


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def test_port_reads_the_jax_package_checkpoint(tmp_path):
    from oct_image_segmentation_models_tpu.common import model_io as jax_model_io

    config, state = _unet_state()
    variables = model_io.flax_from_state_dict(state)
    path = tmp_path / "jax.hdf5"
    jax_model_io.save_model(path, "unet", config, variables, opt_state_bytes=b"\x01\x02")
    name, got_config, got = model_io.read_checkpoint(path)
    assert (name, got_config) == ("unet", json.loads(json.dumps(config)))
    want, got = _flat(variables), _flat(got)
    assert sorted(want) == sorted(got)
    for key in want:
        assert want[key].dtype == got[key].dtype and want[key].tobytes() == got[key].tobytes()
    loaded = model_io.load_model(path, device="cpu")
    for key, value in state.items():
        assert torch.equal(loaded.module.state_dict()[key], value), key


def test_jax_package_reads_the_port_checkpoint(tmp_path):
    from oct_image_segmentation_models_tpu.common import model_io as jax_model_io

    config, state = _unet_state()
    path = tmp_path / "port.hdf5"
    model_io.save_model(path, "unet", config, state)
    name, got_config, got, opt_state = jax_model_io.load_model(path)
    assert (name, got_config, opt_state) == ("unet", json.loads(json.dumps(config)), None)
    want, got = _flat(model_io.flax_from_state_dict(state)), _flat(got)
    assert sorted(want) == sorted(got)
    for key in want:
        assert want[key].dtype == got[key].dtype and want[key].tobytes() == got[key].tobytes()


def test_keras_export_reads_back_through_h5py(tmp_path):
    config, state = _unet_state()
    path = model_io.save_keras_weights(tmp_path / "keras.h5", "unet", config, state)
    with h5py.File(path, "r") as f:
        names = [n.decode() for n in f.attrs["layer_names"]]
        assert names[0] == "conv2d" and names[-1] == "conv2d_12"
        assert f.attrs["keras_version"] == b"2.9.0"
        kernel = f["conv2d/conv2d/kernel:0"][()]
    np.testing.assert_array_equal(kernel, state["blocks.0.conv.weight"].numpy().transpose(2, 3, 1, 0))
    loaded, _ = model_io.load_keras_model(path, device="cpu")
    for key, value in state.items():
        assert torch.equal(loaded.module.state_dict()[key], value), key
