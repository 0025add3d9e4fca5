"""The PyTorch port's host runtime against the JAX package's.

The port's native library (``runtime/csrc/asg_host.cpp``, built with g++ at
the first native call) must give the NumPy arm's arrays: exactly for
``pack_frames``, ``encode_targets`` and ``collapse_path``, within atol 1e-5
for ``cmvn``.  The port's arms are held against the JAX package's NumPy arms
(``use_native=False``, so the JAX package never builds its own library from
these tests).  Bucketing and the prefetcher carry over as written; each
prefetcher case runs under a deadline of its own, so a hang fails.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_asg_tpu.runtime as jrt
import torch_asg_tpu_torch.runtime as rt
from torch_asg_tpu_torch import asg_loss
from torch_asg_tpu_torch.runtime import host

REPO = Path(__file__).resolve().parent.parent


def _within(seconds, fn):
    """Run ``fn`` in a thread; fail if it has not returned after ``seconds``,
    and re-raise what it raised."""
    outcome = {}

    def run():
        try:
            fn()
        except BaseException as exc:  # handed to the test's thread
            outcome["error"] = exc

    worker = threading.Thread(target=run, daemon=True)
    worker.start()
    worker.join(timeout=seconds)
    assert not worker.is_alive(), f"still running after {seconds} s"
    if "error" in outcome:
        raise outcome["error"]


def test_native_runtime_built():
    assert rt.has_native_runtime(), host._lib_error


def _utterances(rng, lengths=(5, 3, 7, 1), feat_dim=8):
    return [np.asarray(rng.normal(size=(t, feat_dim)), np.float32) for t in lengths]


def test_pack_frames_parity(rng):
    utts = _utterances(rng)
    out_np, len_np = rt.pack_frames(utts, pad_value=-1.0, use_native=False)
    assert out_np.shape == (7, 4, 8) and len_np.tolist() == [5, 3, 7, 1]
    assert np.all(out_np[5:, 0] == -1.0)
    out_c, len_c = rt.pack_frames(utts, pad_value=-1.0, use_native=True)
    want, want_len = jrt.pack_frames(utts, pad_value=-1.0, use_native=False)
    for out, lengths in ((out_np, len_np), (out_c, len_c)):
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(lengths, want_len)
        assert out.dtype == np.float32 and lengths.dtype == np.int32


@pytest.mark.parametrize(
    "labels,expected",
    [
        ([0, 1, 2], [0, 1, 2]),
        ([0, 0, 1], [0, 26, 1]),  # a double: the one-repeat symbol, 26
        ([0, 0, 0, 1], [0, 27, 1]),  # a triple: the two-repeat symbol, 27
        ([3, 3, 3, 3], [3, 27, 3]),  # a 4-run: triple + single
        ([5, 5, 5, 5, 5, 5], [5, 27, 5, 27]),  # a 6-run: two triples
        ([], []),
    ],
)
@pytest.mark.parametrize("native", [False, True])
def test_encode_semantics(labels, expected, native):
    got, lens = rt.encode_targets([np.asarray(labels, np.int32)], 26, max_reps=2,
                                  use_native=native)
    assert got[0, : lens[0]].tolist() == expected
    want, want_lens = jrt.encode_targets([np.asarray(labels, np.int32)], 26, max_reps=2,
                                         use_native=False)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lens, want_lens)


def test_encode_parity_random(rng):
    seqs = [np.asarray(rng.integers(0, 5, size=rng.integers(0, 20)), np.int32)
            for _ in range(16)]
    want, want_len = jrt.encode_targets(seqs, 5, max_reps=2, use_native=False)
    for native in (False, True):
        got, lens = rt.encode_targets(seqs, 5, max_reps=2, pad_value=-7, use_native=native)
        np.testing.assert_array_equal(lens, want_len)
        np.testing.assert_array_equal(got, jrt.encode_targets(seqs, 5, max_reps=2,
                                                              pad_value=-7,
                                                              use_native=False)[0])
        assert got.shape == want.shape


def test_encode_collapse_roundtrip():
    seq = np.asarray([1, 1, 2, 3, 3, 3, 4], np.int32)
    for native in (False, True):
        enc, lens = rt.encode_targets([seq], 26, max_reps=2, use_native=native)
        framewise = np.repeat(enc[0, : lens[0]], 3)  # each label held 3 frames
        dec = rt.collapse_path(framewise, alphabet_size=26, max_reps=2, use_native=native)
        np.testing.assert_array_equal(dec, seq)


def test_collapse_path_parity(rng):
    path = np.asarray([0, 0, 1, -1, 1, 2, 2, 26, 26, 3, -1, -1], np.int32)
    paths = [path, rng.integers(-1, 29, size=200).astype(np.int32), np.zeros(0, np.int32)]
    for p in paths:
        for alphabet, reps in ((26, 2), (0, 2), (26, 0), (24, 4)):
            want = jrt.collapse_path(p, alphabet, reps, use_native=False)
            for native in (False, True):
                got = rt.collapse_path(p, alphabet, reps, use_native=native)
                np.testing.assert_array_equal(got, want)
                assert got.dtype == np.int32
    # -1 dropped, runs merged (also across -1 gaps), 26 expands the label once
    assert rt.collapse_path(path, 26, 2, use_native=True).tolist() == [0, 1, 2, 2, 3]
    # a tensor path gives the same sequence
    assert rt.collapse_path(torch.from_numpy(path), 26, 2).tolist() == [0, 1, 2, 2, 3]


def test_collapse_path_default_expands_rep_symbols():
    num_labels = 5
    path = np.asarray([2, 2, num_labels, 3], np.int32)  # a a rep1 b -> a a b
    for native in (True, False):
        assert rt.collapse_path(path, alphabet_size=num_labels,
                                use_native=native).tolist() == [2, 2, 3]
    labels = np.asarray([4, 4, 4, 1, 2, 2], np.int64)
    enc, ln = rt.encode_targets([labels], alphabet_size=num_labels)
    assert rt.collapse_path(enc[0][: int(ln[0])], alphabet_size=num_labels).tolist() == \
        labels.tolist()


def test_cmvn_native_matches_numpy():
    r = np.random.default_rng(11)
    utts = [
        np.asarray(r.normal(loc=3.0, scale=2.5, size=(40, 8)), np.float32),
        np.asarray(r.normal(loc=-1.0, scale=0.2, size=(7, 8)), np.float32),
        np.zeros((1, 8), np.float32),  # zero variance
        np.zeros((0, 8), np.float32),  # no frames
    ]
    out_native = rt.cmvn(utts, use_native=True)
    out_np = rt.cmvn(utts, use_native=False)
    want = jrt.cmvn(utts, use_native=False)
    for a, b, w in zip(out_native, out_np, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(b, w)
        assert a.dtype == np.float32 and a.shape == w.shape
    np.testing.assert_allclose(out_np[0].mean(axis=0), 0.0, atol=1e-5)
    np.testing.assert_allclose(out_np[0].var(axis=0), 1.0, atol=1e-3)
    assert float(utts[0].mean()) != 0.0  # inputs untouched


def test_cmvn_mean_only():
    r = np.random.default_rng(12)
    u = np.asarray(r.normal(loc=5.0, scale=3.0, size=(30, 4)), np.float32)
    for native in (True, False):
        (out,) = rt.cmvn([u], norm_var=False, use_native=native)
        np.testing.assert_allclose(out.mean(axis=0), 0.0, atol=1e-4)
        np.testing.assert_allclose(out.var(axis=0), u.var(axis=0), rtol=1e-4)


@pytest.mark.parametrize("native", [False, True])
def test_pack_frames_and_cmvn_reject_flat_utterance(native):
    with pytest.raises(ValueError, match="expected"):
        rt.pack_frames([np.zeros(16, np.float32)], use_native=native)
    with pytest.raises(ValueError, match="expected"):
        rt.cmvn([np.zeros(16, np.float32)], use_native=native)
    with pytest.raises(ValueError, match="feature dim"):
        rt.pack_frames([np.zeros((3, 4), np.float32), np.zeros((3, 5), np.float32)],
                       use_native=native)


def test_use_native_true_raises_without_library(monkeypatch, tmp_path, rng):
    """A library that cannot be built: ``None`` falls back to NumPy, and
    ``True`` raises with the reason (the JAX package falls back there)."""
    monkeypatch.setattr(host, "SOURCE", tmp_path / "missing.cpp")
    monkeypatch.setattr(host, "BUILD", tmp_path / "build")
    monkeypatch.setattr(host, "_lib", None)
    monkeypatch.setattr(host, "_lib_error", None)
    assert not rt.has_native_runtime()
    assert isinstance(host._lib_error, OSError)
    utts = _utterances(rng)
    with pytest.raises(RuntimeError, match="use_native=True"):
        rt.pack_frames(utts, use_native=True)
    with pytest.raises(RuntimeError, match="use_native=True"):
        rt.collapse_path(np.zeros(3, np.int32), use_native=True)
    np.testing.assert_array_equal(rt.pack_frames(utts)[0],
                                  rt.pack_frames(utts, use_native=False)[0])


_BUILD_ONE = """
import sys
from pathlib import Path
from torch_asg_tpu_torch.runtime import host
host.BUILD = Path(sys.argv[1])
print(host.has_native_runtime(), host._lib_error)
"""


def test_concurrent_builds(tmp_path):
    """Processes that build the library at once each succeed, and leave one
    library and no temporary file."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 and o.startswith("True") for p, o in zip(procs, outs)), outs
    assert [p.name for p in tmp_path.iterdir()] == [host.library_path().name]


def test_prefetcher_order_and_contents():
    def run():
        with rt.BatchPrefetcher(list(range(20)), lambda x: x * x, depth=3) as pf:
            assert list(pf) == [x * x for x in range(20)]

    _within(10, run)


def test_prefetcher_propagates_exceptions():
    def bad(x):
        if x == 3:
            raise RuntimeError("boom at 3")
        return x

    def run():
        got = []
        with pytest.raises(RuntimeError, match="boom at 3"):
            for v in rt.BatchPrefetcher(range(10), bad, depth=2):
                got.append(v)
        assert got == [0, 1, 2]

    _within(10, run)


def test_prefetcher_exception_with_full_queue_and_slow_consumer():
    """The error reaches a slow consumer even when the bounded queue is full
    when the worker raises."""
    def bad(x):
        if x == 1:
            raise RuntimeError("late boom")
        return x

    def run():
        pf = rt.BatchPrefetcher(range(5), bad, depth=1)
        time.sleep(1.5)  # the worker fills the depth-1 queue and raises
        assert next(pf) == 0
        with pytest.raises(RuntimeError, match="late boom"):
            next(pf)

    _within(15, run)


def test_prefetcher_repeated_stopiteration():
    def run():
        pf = rt.BatchPrefetcher([1, 2], lambda x: x, depth=2)
        assert list(pf) == [1, 2]
        for _ in range(3):
            with pytest.raises(StopIteration):
                next(pf)

    _within(10, run)


def test_prefetcher_early_close_stops_worker():
    produced = []

    def prepare(x):
        produced.append(x)
        return x

    def run():
        pf = rt.BatchPrefetcher(range(10_000), prepare, depth=2)
        assert next(pf) == 0
        pf.close()
        assert not pf._worker.is_alive()
        assert len(produced) < 50  # the worker ran no further than the queue allows
        with pytest.raises(StopIteration):
            next(pf)

    _within(15, run)


def test_prefetcher_close_unblocks_blocked_consumer():
    """close() from another thread wakes a consumer blocked in __next__ on
    an empty queue."""
    gate = threading.Event()

    def slow_prepare(x):
        gate.wait(timeout=10.0)  # hold the queue empty until close()
        return x

    def run():
        pf = rt.BatchPrefetcher(range(3), slow_prepare, depth=1)
        result = {}

        def consume():
            try:
                next(pf)
                result["outcome"] = "item"
            except StopIteration:
                result["outcome"] = "stopped"

        consumer = threading.Thread(target=consume)
        consumer.start()
        time.sleep(0.3)  # the consumer is blocked in __next__
        pf.close()
        gate.set()
        consumer.join(timeout=5.0)
        assert not consumer.is_alive(), "consumer stayed blocked after close()"
        assert result["outcome"] == "stopped"

    _within(20, run)


def test_prefetcher_rejects_depth_zero():
    with pytest.raises(ValueError, match="depth"):
        rt.BatchPrefetcher([1], lambda x: x, depth=0)


def test_device_prefetch_cpu():
    batches = [{"x": np.ones((4, 3), np.float32) * i, "n": np.int32(i),
                "pair": (np.arange(3), [np.zeros(2, np.int64)])} for i in range(3)]

    def run():
        with rt.device_prefetch(batches, lambda b: b, depth=2, device="cpu") as pf:
            out = list(pf)
        assert len(out) == 3
        assert isinstance(out[1]["x"], torch.Tensor) and out[1]["x"].device.type == "cpu"
        np.testing.assert_array_equal(out[2]["x"].numpy(), batches[2]["x"])
        assert out[2]["n"].item() == 2 and out[2]["n"].dtype == torch.int32
        assert isinstance(out[0]["pair"], tuple) and isinstance(out[0]["pair"][1], list)
        np.testing.assert_array_equal(out[0]["pair"][0].numpy(), np.arange(3))

    _within(10, run)


def test_bucket_ladder_and_pick():
    ladder = rt.bucket_ladder(1000, num_buckets=6, min_value=50)
    assert ladder == jrt.bucket_ladder(1000, num_buckets=6, min_value=50)
    assert ladder[-1] == 1000 and ladder[0] == 50
    assert ladder == sorted(set(ladder)) and len(ladder) <= 6
    assert rt.bucket_ladder(1000, num_buckets=1, min_value=50) == [1000]
    assert rt.pick_bucket(50, ladder) == 50
    assert rt.pick_bucket(51, ladder) == ladder[1]
    assert rt.pick_bucket(1000, ladder) == 1000
    with pytest.raises(ValueError, match="exceeds"):
        rt.pick_bucket(1001, ladder)
    with pytest.raises(ValueError, match="num_buckets"):
        rt.bucket_ladder(10, min_value=16)


def test_bucket_batcher_bounded_shapes_and_contents():
    """Every batch shape comes from the bucket grid, each utterance comes
    out once with its own labels, and the batches equal the JAX package's."""
    r = np.random.default_rng(3)
    utts = []
    for _ in range(11):
        feats = np.asarray(r.normal(size=(int(r.integers(2, 33)), 5)), np.float32)
        utts.append((feats, r.integers(0, 9, size=int(r.integers(1, 8)))))
    kwargs = dict(batch_size=3, time_buckets=[8, 16, 32], target_buckets=[4, 8])
    bb = rt.BucketBatcher(**kwargs)
    batches = list(bb.batches(iter(utts)))
    want = list(jrt.BucketBatcher(**kwargs).batches(iter(utts)))
    assert len(batches) == len(want)
    for got, w in zip(batches, want):
        assert got.keys() == w.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], w[key])
            assert got[key].dtype == w[key].dtype
    seen = {}
    for b in batches:
        t_b, b_b, f = b["features"].shape
        assert t_b in kwargs["time_buckets"] and b_b == 3 and f == 5
        assert b["targets"].shape[1] in kwargs["target_buckets"]
        for i in np.flatnonzero(b["pad_mask"]):
            key = b["features"][: int(b["feature_lengths"][i]), i].tobytes()
            seen[key] = b["targets"][i, : int(b["target_lengths"][i])].tolist()
    assert len(seen) == len(utts)
    for feats, labels in utts:
        assert seen[feats.tobytes()] == list(labels)
    assert sum(int(b["pad_mask"].sum()) for b in batches) == len(utts)
    assert bb.flush() == []


def test_bucket_batcher_encodes_targets():
    """With an alphabet, labels are encoded into the extended alphabet."""
    bb = rt.BucketBatcher(batch_size=1, time_buckets=[8], target_buckets=[4],
                          alphabet_size=26)
    (batch,) = list(bb.batches([(np.zeros((3, 2), np.float32), [0, 0, 1])]))
    assert batch["targets"][0, : batch["target_lengths"][0]].tolist() == [0, 26, 1]


def test_bucket_batcher_criterion_padding_invariance(rng):
    """A bucket-padded batch scores as the tight one does, element by
    element, through the port's ``asg_loss``."""
    num_labels = 6
    bb = rt.BucketBatcher(batch_size=2, time_buckets=[32], target_buckets=[8])
    utts = [(np.asarray(rng.normal(size=(20, num_labels)), np.float32),
             np.asarray([1, 2, 3], np.int64)),
            (np.asarray(rng.normal(size=(13, num_labels)), np.float32),
             np.asarray([4, 0], np.int64))]
    (batch,) = list(bb.batches(iter(utts)))
    trans = torch.from_numpy(rng.normal(size=(num_labels, num_labels)))
    bucketed = asg_loss(trans, torch.from_numpy(batch["features"]).double(),
                        torch.from_numpy(batch["targets"]),
                        torch.from_numpy(batch["feature_lengths"]),
                        torch.from_numpy(batch["target_lengths"]), reduction="none")
    for i, (feats, labels) in enumerate(utts):
        tight = asg_loss(trans, torch.from_numpy(feats[:, None, :]).double(),
                         torch.from_numpy(np.asarray(labels, np.int32)[None]),
                         torch.tensor([feats.shape[0]], dtype=torch.int32),
                         torch.tensor([len(labels)], dtype=torch.int32), reduction="none")
        np.testing.assert_allclose(bucketed[i].item(), tight[0].item(), rtol=1e-12)


def test_bucketed_streaming_beam_end_to_end(rng):
    """Ragged traffic -> BucketBatcher -> fixed-size streaming chunks that
    cross utterance ends -> streaming beam decode -> backtrace, equal to the
    port's one-shot beam_decode on the bucketed batch, to the JAX package's,
    and to a tight one-shot decode of each utterance."""
    import jax.numpy as jnp

    from torch_asg_tpu import beam_decode as jax_beam_decode
    from torch_asg_tpu_torch import (beam_decode, streaming_beam_backtrace,
                                     streaming_beam_init, streaming_beam_update)

    num_labels, k, chunk = 6, 3, 7  # chunk=7 never divides the time buckets
    bb = rt.BucketBatcher(batch_size=3, time_buckets=[8, 16, 32], target_buckets=[4, 8])
    utts = []
    for _ in range(10):
        t = int(rng.integers(2, 33))
        feats = np.asarray(rng.normal(size=(t, num_labels)), np.float32)
        utts.append((feats, rng.integers(0, num_labels, size=int(rng.integers(1, 5)))))
    trans_np = rng.normal(size=(num_labels, num_labels))
    trans = torch.from_numpy(trans_np)

    decoded = {}
    for batch in bb.batches(iter(utts)):
        emissions = torch.from_numpy(batch["features"]).double()
        lengths = torch.from_numpy(batch["feature_lengths"]).to(torch.int32)
        t_bucket, num_batches = emissions.shape[:2]
        st = streaming_beam_init(num_batches, k, dtype=torch.float64, device="cpu")
        labs, bps, vals = [], [], []
        for off in range(0, t_bucket, chunk):
            t_c = min(chunk, t_bucket - off)
            cl = (lengths - off).clamp(0, t_c)
            st, (lab, bp, v) = streaming_beam_update(trans, st, emissions[off:off + t_c],
                                                     chunk_lengths=cl)
            labs.append(lab)
            bps.append(bp)
            vals.append(v)
        got = streaming_beam_backtrace(st, torch.cat(labs), torch.cat(bps), torch.cat(vals))
        want = beam_decode(trans, emissions, lengths, beam_size=k)
        assert torch.equal(got.scores, want.scores) and torch.equal(got.paths, want.paths)
        jwant = jax_beam_decode(jnp.asarray(trans_np), jnp.asarray(emissions.numpy()),
                                jnp.asarray(lengths.numpy()), beam_size=k)
        np.testing.assert_allclose(got.scores.numpy(), np.asarray(jwant.scores), rtol=1e-12)
        np.testing.assert_array_equal(got.paths.numpy(), np.asarray(jwant.paths))
        for i in range(num_batches):
            if not batch["pad_mask"][i]:
                continue
            length = int(lengths[i])
            key = batch["features"][:length, i].tobytes()
            decoded[key] = (got.scores[i].item(), got.paths[:length, i].numpy())

    assert len(decoded) == len(utts)
    for feats, _ in utts:
        score, path = decoded[feats.tobytes()]
        tight = beam_decode(trans, torch.from_numpy(feats[:, None, :]).double(),
                            torch.tensor([feats.shape[0]], dtype=torch.int32), beam_size=k)
        np.testing.assert_allclose(score, tight.scores[0].item(), rtol=1e-12)
        np.testing.assert_array_equal(path, tight.paths[:, 0].numpy())
