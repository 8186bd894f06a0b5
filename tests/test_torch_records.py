"""The port's input pipeline (k8s_tpu_torch/data: ``records``,
``native_loader``, ``prefetch``) held to the JAX package's, and
``resnet_train`` on written record shards, on the CPU.

- Both writers write the same bytes under the same file names
  (``<prefix>-<s>-of-<n>.rec``, image ``i`` in shard ``i % n``); the JAX
  reader reads the port's shards and the port's reader the JAX ones,
  each batch equal to the written images and labels.
- With the same seed and shuffle buffer (one reader thread, so the
  order is the loader's alone) the port's loader and the JAX one give
  identical uint8 batches.
- The loader's zero-copy ring yields every record once, the short last
  batch kept or dropped, and is released only after ``close``.
- The port's loader library is built by g++ from
  ``native/data_loader.cc`` alone into the port's git-ignored build
  directory, keyed by a hash of the source, with nothing of the JAX
  package imported; without g++ it raises.
- ``prefetch_to_device`` on the CPU yields the host batches as tensors
  in order, forwards the host iterator's exception, stops its thread
  when the consumer walks away, and refuses ``cuda`` without a card.
- ``resnet_train --tiny=1`` on written shards with ``--eval_every``:
  preempted after step 3 (exit 143, the flush at step 3), its losses
  bit-equal to an unbroken run's; restarted, it restores the step-3
  state and reads the record stream from its start, as the JAX program
  does: its losses, and its final parameters, BN running averages and
  momentum, bit-equal to the unbroken run's step-3 state stepped on the
  stream's first batches. The shard guards of the JAX program hold (no
  train shards, no eval shards, eval shards shorter than a batch).
"""

import os
import pathlib
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from k8s_tpu.data import records as jrecords
from k8s_tpu_torch.data import native_loader as tloader
from k8s_tpu_torch.data import records as trecords
from k8s_tpu_torch.data.prefetch import prefetch_to_device

REPO = pathlib.Path(__file__).resolve().parent.parent


def _images(n, size=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.integers(0, 1000, (n,)))


def test_both_writers_write_the_same_files(tmp_path):
    images, labels = _images(11)
    tp = trecords.write_image_shards(str(tmp_path / "t"), images, labels, num_shards=3)
    jp = jrecords.write_image_shards(str(tmp_path / "j"), images, labels, num_shards=3)
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p) for p in jp] == [
        f"train-0000{s}-of-00003.rec" for s in range(3)]
    for a, b in zip(tp, jp):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    assert trecords.record_bytes(8) == jrecords.record_bytes(8) == 8 + 8 * 8 * 3
    with pytest.raises(ValueError, match="square"):
        trecords.write_image_shards(str(tmp_path), images[:, :, :4], labels)


@pytest.mark.parametrize("writer,reader", [(trecords, jrecords), (jrecords, trecords)])
def test_each_reader_reads_the_other_writers_shards(tmp_path, writer, reader):
    images, labels = _images(10)
    paths = writer.write_image_shards(str(tmp_path), images, labels, num_shards=2)
    got = list(reader.image_record_batches(paths[:1], 5, 8, loop=False))
    assert len(got) == 1
    np.testing.assert_array_equal(got[0]["images"], images[0::2])
    np.testing.assert_array_equal(got[0]["labels"], labels[0::2].astype(np.int32))
    assert got[0]["labels"].dtype == np.int32 and got[0]["images"].dtype == np.uint8


def test_same_seed_and_shuffle_give_identical_batches(tmp_path):
    images, labels = _images(40)
    paths = trecords.write_image_shards(str(tmp_path), images, labels, num_shards=2)
    kw = dict(shuffle_buffer=12, seed=7, num_threads=1)
    t_it = trecords.image_record_batches(paths, 6, 8, **kw)
    j_it = jrecords.image_record_batches(paths, 6, 8, **kw)
    try:
        for _ in range(15):  # past one epoch: the loop and the reservoir
            t, j = next(t_it), next(j_it)
            assert t["images"].dtype == j["images"].dtype == np.uint8
            np.testing.assert_array_equal(t["images"], j["images"])
            np.testing.assert_array_equal(t["labels"], j["labels"])
    finally:
        t_it.close()
        j_it.close()


def test_loader_is_built_from_the_source_alone_into_the_ignored_build_dir():
    code = ("import sys\n"
            "from k8s_tpu_torch.data import native_loader as n\n"
            "lib = n.load()\n"
            "print(n.library_path())\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('k8s_tpu', 'jax', 'flax')))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    path, mods = res.stdout.strip().splitlines()[-2:]
    path = pathlib.Path(path)
    assert mods == "[]"
    assert path.exists() and path.parent == tloader.BUILD_DIR
    assert path.name.startswith("libktpu_loader-") and path.suffix == ".so"
    assert tloader.SOURCE == REPO / "native" / "data_loader.cc"
    ignored = subprocess.run(["git", "check-ignore", "-q", str(path)], cwd=REPO)
    assert ignored.returncode == 0, f"{path} is not git-ignored"


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tloader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tloader.shutil, "which", lambda name: None)
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tloader.build()


@pytest.mark.parametrize("drop_remainder,sizes", [(False, [3, 3, 1]), (True, [3, 3])])
def test_native_loader_zero_copy_ring(tmp_path, drop_remainder, sizes):
    images, labels = _images(7)
    paths = trecords.write_image_shards(str(tmp_path), images, labels)
    with tloader.NativeRecordLoader(paths, trecords.record_bytes(8), 3,
                                    drop_remainder=drop_remainder) as ld:
        got = [b.copy() for b in ld.iter_zero_copy()]  # each view dies next call
        assert ld._ring is not None
    assert [len(b) for b in got] == sizes
    n = sum(sizes)
    records = np.concatenate(got)
    np.testing.assert_array_equal(records[:, 8:].reshape(n, 8, 8, 3), images[:n])
    np.testing.assert_array_equal(records[:, :8].copy().view("<i8").ravel(), labels[:n])
    assert ld._ring is None  # released only after close joined the producers
    with pytest.raises(RuntimeError, match="closed"):
        ld.next_zero_copy()


def test_prefetch_yields_the_batches_in_order_on_the_cpu():
    host = [{"x": np.full((2, 3), i, np.float32), "y": np.arange(2) + i}
            for i in range(5)]
    got = list(prefetch_to_device(iter(host), "cpu", buffer_size=2))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))
        assert torch.equal(b["y"], torch.from_numpy(np.arange(2) + i))


def test_prefetch_forwards_the_error_and_stops_when_abandoned():
    def failing():
        yield {"x": np.zeros(1)}
        raise OSError("disk gone")

    it = prefetch_to_device(failing(), "cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.zeros(1) + i}
            i += 1

    before = {t.ident for t in threading.enumerate()}
    it = prefetch_to_device(endless(), "cpu", buffer_size=1)
    next(it)
    it.close()  # the consumer walks away with the queue full
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and any(
            t.name == "prefetch" and t.ident not in before for t in threading.enumerate()):
        time.sleep(0.02)
    assert not [t for t in threading.enumerate()
                if t.name == "prefetch" and t.ident not in before]
    assert len(produced) <= 4


def test_prefetch_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_to_device(iter([]), "cuda"))


# ---------------------------------------------------------------------------
# resnet_train on records
# ---------------------------------------------------------------------------

ARGS = "--device=cpu --tiny=1 --batch_size=4 --log_every=1 --eval_every=2 --eval_steps=2"
STEPS, PREEMPT_AFTER = 6, 3


def _write_shards(d):
    images, labels = _images(24, size=64, seed=1)
    trecords.write_image_shards(d, images, labels % 100, num_shards=1)
    images, labels = _images(8, size=64, seed=2)
    trecords.write_image_shards(d, images, labels % 100, num_shards=1, prefix="eval")


def _run(args):
    import contextlib
    import io
    import json

    from k8s_tpu_torch.programs import resnet_train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            res = resnet_train.main(types.SimpleNamespace(
                process_id=0, num_processes=1, program_args=args))
        except SystemExit as e:
            res = e.code
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return res, lines


def _losses(lines, key):
    return {e["step"]: e[key] for e in lines if key in e}


def test_preempted_resnet_train_resumes_bit_equal(tmp_path, monkeypatch):
    from k8s_tpu_torch.programs import common
    from k8s_tpu_torch.train import state_tree

    torch.set_num_threads(2)
    data = str(tmp_path / "data")
    _write_shards(data)
    for key in ("KTPU_CKPT_DIR", "KTPU_CKPT_PERSIST_EVERY", "KTPU_PREEMPT_REQUESTED",
                "KTPU_STEPS"):
        monkeypatch.delenv(key, raising=False)
    # the program marks this process preemption-aware (it sets
    # KTPU_PREEMPT_AWARE=1): set here, so that the end of the test unsets
    # it (delenv of an absent key restores nothing) and pods a later test
    # starts from this process do not inherit it
    monkeypatch.setenv("KTPU_PREEMPT_AWARE", "0")
    base = f"{ARGS} --data_dir={data}"
    ref, unbroken = _run(f"{base} --steps={PREEMPT_AFTER}")
    assert isinstance(ref, dict)
    polls = {"n": 0}

    def flag():
        polls["n"] += 1
        return polls["n"] >= PREEMPT_AFTER

    ckpt = tmp_path / "ckpt"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "preempt_requested", flag)
        code, first = _run(f"{base} --steps={STEPS} --checkpoint_dir={ckpt}")
    assert code == 143
    assert {"event": "preempt_checkpoint", "step": PREEMPT_AFTER} in first
    assert sorted(os.listdir(ckpt)) == [str(PREEMPT_AFTER)]
    assert _losses(first, "loss") == _losses(unbroken, "loss")
    assert sorted(_losses(first, "loss")) == list(range(1, PREEMPT_AFTER + 1))
    assert _losses(first, "eval_loss") == {2: _losses(unbroken, "eval_loss")[2]}
    resumed, second = _run(f"{base} --steps={STEPS} --checkpoint_dir={ckpt}")
    assert {"event": "restored", "step": PREEMPT_AFTER} in second
    # the unbroken run's step-3 state on the stream from its start (the
    # program's loader settings: a shuffle buffer of 4 batches, rank 0's seed)
    state, step_fn = ref["state"], ref["step_fn"]
    stream = trecords.image_record_batches(
        [os.path.join(data, "train-00000-of-00001.rec")], 4, 64,
        shuffle_buffer=16, seed=0)
    want = {}
    for step in range(PREEMPT_AFTER + 1, STEPS + 1):
        state, m = step_fn(state, {k: torch.from_numpy(v) for k, v in next(stream).items()})
        want[step] = float(m["loss"])
    stream.close()
    assert dict(resumed["losses"]) == want  # the summary's unrounded losses
    assert sorted(_losses(second, "loss")) == sorted(want)
    assert sorted(_losses(second, "eval_loss")) == [4, 6]
    got, expect = state_tree(resumed["state"]), state_tree(state)
    assert sorted(got) == sorted(expect)
    assert any(k.startswith("batch_stats/") for k in got)
    assert any(k.endswith("/momentum_buffer") for k in got)
    for k, v in expect.items():
        assert torch.equal(got[k], v), k
    # the final force-save wrote the last step, with the BN stats and momentum
    assert str(STEPS) in os.listdir(ckpt)


@pytest.mark.parametrize("layout,match", [
    ({}, "no .rec shards"),
    ({"train": 1}, "no eval-"),
    ({"train": 1, "eval_records": 2}, "fewer records than one batch"),
])
def test_resnet_train_refuses_missing_or_short_shards(tmp_path, layout, match):
    data = tmp_path / "d"
    data.mkdir()
    if layout.get("train"):
        trecords.write_image_shards(str(data), *_images(8, size=64), num_shards=1)
    if layout.get("eval_records"):
        trecords.write_image_shards(str(data), *_images(layout["eval_records"], size=64),
                                    num_shards=1, prefix="eval")
    with pytest.raises((FileNotFoundError, ValueError), match=match):
        _run(f"{ARGS} --data_dir={data} --steps=1")
