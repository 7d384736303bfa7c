"""The port's msgpack weight files against flax.serialization on CPU: every
committed ``artifacts/*.msgpack`` read bitwise as ``msgpack_restore`` reads
it and written back byte for byte; a file the port writes loads through the
JAX package's ``load_params`` with equal leaves; the codec on the scalar,
string and container forms flax emits."""

import glob
import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from plasma_control_tpu.control.rl.networks import SpectralAttentionActor as JAttention
from plasma_control_tpu.io.checkpoint import load_params as jload_params
from plasma_control_tpu.io.checkpoint import save_params as jsave_params
from plasma_control_tpu_torch.control.rl.networks import SpectralAttentionActor, SpectralActor
from plasma_control_tpu_torch.interop import actor_params_to_numpy
from plasma_control_tpu_torch.io.checkpoint import load_params, packb, save_params, unpackb

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = sorted(glob.glob(os.path.join(ROOT, "artifacts", "*.msgpack")))


def _same_tree(a, b):
    """Equal keys in equal order, leaves of equal type, dtype, shape and bytes."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same_tree(a[k], b[k])
    else:
        assert type(a) is type(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_all_ten_artifacts_present():
    assert len(ARTIFACTS) == 10, ARTIFACTS


@pytest.mark.parametrize("path", ARTIFACTS, ids=os.path.basename)
def test_reader_bitwise_as_flax_and_writer_byte_identical(path):
    with open(path, "rb") as f:
        raw = f.read()
    mine = unpackb(raw)
    _same_tree(mine, flax.serialization.msgpack_restore(raw))
    assert packb(mine) == raw


def test_port_written_actor_loads_in_jax(tmp_path):
    """A freshly drawn attention actor written by the port loads through
    JAX's ``load_params`` into the flax module's tree, leaf for leaf equal,
    and is byte-identical to flax's own ``to_bytes`` of the same tree (both
    keep the tree's key order)."""
    net = SpectralAttentionActor(16, 4, n_modes=4, d_model=8, n_heads=2, n_layers=2,
                                 generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "sub" / "actor.msgpack")
    save_params(path, actor_params_to_numpy(net))
    like = JAttention(16, 4, n_modes=4, d_model=8, n_heads=2, n_layers=2).init(
        jax.random.PRNGKey(0), np.zeros((1, 40), np.float32))
    got = jload_params(path, like)
    want = actor_params_to_numpy(net)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with open(path, "rb") as f:
        assert f.read() == flax.serialization.to_bytes(want)


def test_jax_written_file_loads_into_port_network(tmp_path):
    """The JAX package's ``save_params`` of a port actor's tree loads back
    into a port network with the same weights."""
    net = SpectralActor(8, 4, n_modes=3, generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "jax.msgpack")
    jsave_params(path, jax.tree.map(jax.numpy.asarray, actor_params_to_numpy(net)))
    back = load_params(path, like=SpectralActor(8, 4, n_modes=3,
                                                generator=torch.Generator().manual_seed(2)))
    for (ka, a), (kb, b) in zip(net.state_dict().items(), back.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


def test_codec_forms():
    """Every form of the subset, against flax's writer and reader."""
    tree = {
        "i": {"small": np.int32(5), "neg": np.int64(-3)},
        "arrays": {"f64": np.arange(6.0).reshape(2, 3), "i8": np.array([-1, 2], np.int8),
                   "scalar0d": np.array(1.5, np.float32), "empty": np.zeros((0, 3), np.float32),
                   "bool": np.array([True, False])},
        "k" * 40: np.ones(300, np.float32),  # str8 key, ext16 payload
        "big": np.ones(20000, np.float32),  # ext32 payload
    }
    raw = packb(tree)
    assert raw == flax.serialization.to_bytes(tree)
    _same_tree(unpackb(raw), flax.serialization.msgpack_restore(raw))
    plain = {"none": None, "t": True, "f": False, "ints": [0, 127, 128, -32, -33, 70000, -70000,
                                                          2**40, -(2**40)],
             "x": 0.25, "s": "text", "b": b"\x00\x01"}
    assert unpackb(packb(plain)) == plain
    with pytest.raises(ValueError):
        unpackb(packb(plain) + b"\x00")
