"""The port's data × model mesh (``silent_speech_tpu_torch/parallel``)
against the JAX package's ``parallel/mesh.py``: the partition rules leaf
by leaf under the layout map (names only, nothing compiled), the batch
split against JAX's ``shard_batch`` on the same packed batch, exact round
trips of ``shard_state`` / ``gather_state`` over a gloo mesh of four
processes (AdamW moments included), and the dropout masks of the shards,
concatenated, ``torch.equal`` to the one-process masks."""

import numpy as np
import pytest
import torch

import jax
from silent_speech_tpu.data.packing import pack_batch as jax_pack_batch
from silent_speech_tpu.parallel import mesh as jax_mesh
from silent_speech_tpu_torch.data.packing import DeviceBatch, pack_batch
from silent_speech_tpu_torch.models.convert import encoder_leaves
from silent_speech_tpu_torch.ops.dropout import Shard, keep_mask
from silent_speech_tpu_torch.ops.rel_attention import attention_keep
from silent_speech_tpu_torch.parallel import launch
from silent_speech_tpu_torch.parallel.mesh import (Mesh, flax_spec,
                                                   param_partition_spec,
                                                   shard_batch)

import torch_mesh_workers as workers
from torch_port_util import example_dict, one_torch_thread

LEAVES = [leaf for leaf in encoder_leaves(2, [True] * 3, True) if leaf[1]]
DIM_MAPS = {"dense": {0: 1, 1: 0}, "conv": {0: 2, 1: 1, 2: 0}}


@pytest.mark.parametrize("key,path,kind", LEAVES,
                         ids=[leaf[0] for leaf in LEAVES])
def test_partition_spec_is_jax_s_under_the_layout_map(key, path, kind):
    flax_path = "/".join(path[1:])
    spec = tuple(jax_mesh.param_partition_spec(flax_path))
    assert flax_spec(flax_path) == spec     # the port's copy of the rules
    sharded = [(d, a) for d, a in enumerate(spec) if a is not None]
    want = None
    if sharded:
        (flax_dim, axis), = sharded
        want = (DIM_MAPS.get(kind, {}).get(flax_dim, flax_dim), axis)
    assert param_partition_spec(key) == want


def test_the_rules_shard_what_jax_s_comment_says():
    # a torch conv weight (Cout, Cin, K) splits its output channels, dim 0
    assert param_partition_spec("conv_blocks.1.conv2.weight") == (0, "model")
    assert param_partition_spec("transformer.layers.0.linear2.weight") \
        == (1, "model")
    assert param_partition_spec("transformer.layers.0.linear2.bias") is None
    assert param_partition_spec("w_raw_in.weight") is None
    assert param_partition_spec("conv_blocks.0.bn1.num_batches_tracked") \
        is None
    assert param_partition_spec("generator.conv_pre.weight") is None


def _fake_mesh(dp, data_rank):
    return Mesh(dp, 1, data_rank, 0, None, None, torch.device("cpu"))


@pytest.mark.parametrize("dp", [2, 4])
def test_shard_batch_splits_as_jax_s(dp):
    rng = np.random.default_rng(3)
    exs = [example_dict(rng, t, silent=i % 2 == 0, t_tgt=t + 5)
           for i, t in enumerate((40, 70, 55, 90, 30))]
    kw = dict(seq_len=50, chunk_bucket=8, utt_bucket=8, fixed_chunks=16,
              fixed_utts=8, fixed_t=128)
    ours = pack_batch(exs, **kw)
    theirs = jax_pack_batch(exs, **kw)
    jmesh = jax_mesh.make_mesh(dp, 1, devices=jax.devices()[:dp])
    jdb = jax_mesh.shard_batch(theirs.device_batch(), jmesh)
    db = DeviceBatch(*(None if getattr(ours, f) is None
                       else torch.as_tensor(np.asarray(getattr(ours, f)))
                       for f in DeviceBatch._fields))
    devices = list(jmesh.devices[:, 0])
    for field in DeviceBatch._fields:
        arr = getattr(jdb, field)
        if arr is None:
            continue
        for r in range(dp):
            part = getattr(shard_batch(db, _fake_mesh(dp, r)), field)
            shard, = [s for s in arr.addressable_shards
                      if s.device == devices[r]]
            np.testing.assert_array_equal(part.numpy(),
                                          np.asarray(shard.data),
                                          err_msg=field)


def test_rows_that_do_not_split_over_data_are_refused():
    # the GAN's segment batch must divide by the data axis
    assert _fake_mesh(2, 1).rows(4) == (2, 2)
    with pytest.raises(ValueError, match="do not split over a data axis"):
        _fake_mesh(2, 0).rows(3)


def test_shard_batch_keeps_an_indivisible_array_whole():
    db = DeviceBatch(*(torch.arange(6).reshape(3, 2) for _ in
                       DeviceBatch._fields))
    part = shard_batch(db, _fake_mesh(2, 1))
    assert torch.equal(part.raw_emg, db.raw_emg)


@pytest.fixture(scope="module")
def round_trips():
    with one_torch_thread():
        return launch.spawn(workers.state_round_trip, 4, (2, 2), threads=1)


def test_state_round_trips_exactly(round_trips):
    # every rank's gather of its shards is the full state, bit for bit:
    # weights, BatchNorm statistics, both AdamW moments
    for rank, (equal, n_sharded, n_total) in enumerate(round_trips):
        assert equal, f"rank {rank}"
        assert 0 < n_sharded < n_total


def test_spawn_gives_each_rank_its_coordinates():
    assert [r[0] for r in launch.spawn(workers.rank_env, 4, (None,),
                                       threads=1)] == [0, 1, 2, 3]


def test_cuda_ranks_need_a_card_each(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    launch.check_ranks(1, torch.device("cuda"))
    with pytest.raises(RuntimeError, match="2 CUDA ranks need 2 cards"):
        launch.check_ranks(2, torch.device("cuda"))


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        launch.spawn(workers.fail_on_rank_one, 2, (None,), threads=1)


# ---- dropout masks of the shards ---------------------------------------
MESHES = [(2, 2), (4, 1), (1, 2)]
B, H, T, D, F = 8, 4, 24, 16, 32


@pytest.mark.parametrize("dp,mp", MESHES)
def test_attention_masks_of_the_shards_are_the_whole(dp, mp):
    whole = attention_keep(B, H, T, 77, 2 ** 31, "cpu")
    b, h = B // dp, H // mp
    rows = [torch.cat([attention_keep(b, h, T, 77, 2 ** 31, "cpu",
                                      b_offset=d * b, h_offset=m * h,
                                      h_total=H)
                       for m in range(mp)], 1) for d in range(dp)]
    assert torch.equal(torch.cat(rows, 0), whole)


@pytest.mark.parametrize("dp,mp", MESHES)
def test_ffn_masks_of_the_shards_are_the_whole(dp, mp):
    # the FFN's (B, T, F) relu output: a data rank's rows, a model rank's
    # columns, indexed (row·T + t)·F + f0 + f
    whole = keep_mask((B, T, F), 5, 51, "cpu")
    b, f = B // dp, F // mp
    rows = [torch.cat([keep_mask((b, T, f), 5, 51, "cpu",
                                 Shard(d * b * T, m * f, F))
                       for m in range(mp)], 2) for d in range(dp)]
    assert torch.equal(torch.cat(rows, 0), whole)


@pytest.mark.parametrize("dp", [2, 4])
def test_residual_masks_of_the_shards_are_the_whole(dp):
    whole = keep_mask((B, T, D), 9, 51, "cpu")
    b = B // dp
    parts = [keep_mask((b, T, D), 9, 51, "cpu", Shard(d * b * T))
             for d in range(dp)]
    assert torch.equal(torch.cat(parts, 0), whole)


def test_an_unaligned_row_offset_takes_its_bytes_from_mid_word():
    # rows of 3 elements: the shard starts at byte 3 of a 32-bit word
    whole = keep_mask((4, 3), 1, 100, "cpu")
    assert torch.equal(keep_mask((3, 3), 1, 100, "cpu", Shard(1)),
                       whole[1:])
