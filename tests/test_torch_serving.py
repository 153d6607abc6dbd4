"""The port's serving stack (``serving/handler.py``, ``serving/server.py``)
against the JAX package's on identical requests, on the CPU.

- ``input_fn`` parses as JAX's does; ``predict_fn`` answers JAX's
  ``predict_fn`` on the same classifier checkpoint and instances (base64
  JPEG fixtures under both keys, a PNG, corrupt base64, no image, empty and
  NA texts, more instances than a batch): the same keys and labels,
  probabilities within fp32 atol 1e-5, for the standard engine and for the
  fast engine with the kernels' plain versions and text buckets.
- ``BatchTransformHandler`` writes JAX's lines (errors included).
- The HTTP server: /ping 200 after the model is loaded and warmed, single
  and batch invocations equal to ``predict_fn``, 8 concurrent requests each
  answered with its own rows (micro-batching off and on), 400 for a bad
  body, 404 for an unknown route, 500 for a model failure.
- ``MicroBatcher``: coalescing and routing, the bypass of large requests,
  an error fanned out to every waiter (the JAX tests' cases).
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from multimodal_content_moderation_tpu.serving import handler as jh
from multimodal_content_moderation_tpu_torch.serving import handler as th
from multimodal_content_moderation_tpu_torch.serving import server as srv
from multimodal_content_moderation_tpu_torch.testdata import jpeg_fixtures

from test_torch_inference import CLASSES, clip_checkpoint  # noqa: F401  (fixture)

ATOL = 1e-5
KNOBS = {
    "standard": {},
    "fast": {"MMHARM_ENGINE": "fast", "MMHARM_ATTENTION": "pallas", "MMHARM_SEQ_BUCKETS": "6,8"},
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _png() -> bytes:
    buf = io.BytesIO()
    g = np.random.default_rng(5)
    Image.fromarray(g.integers(0, 256, size=(40, 50, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def instances(n=40):
    blobs = [_b64(p.read_bytes()) for p in jpeg_fixtures().values()] + [_b64(_png())]
    words = ["hate", "love", "the", "thing", "a"]
    out = []
    for i in range(n):
        inst = {"text": " ".join(words[(i + k) % 5] for k in range(i % 7 + 1))}
        if i % 9 == 4:
            inst["text"] = ["", "NA", "   ", None][i % 4]
        if i % 5 == 3:
            inst["image_base64"] = blobs[i % len(blobs)]
        elif i % 5 != 4:
            inst["image"] = blobs[i % len(blobs)]
        if i == 7:
            inst["image"] = "!!!not-base64!!!"
        out.append(inst)
    return out


def _probs(preds):
    return np.asarray([[p["probabilities"][c] for c in CLASSES] for p in preds])


def _same(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose(_probs(got), _probs(want), atol=ATOL, rtol=0)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"class_predictions", "probabilities", "any_harmful"}
        assert g["class_predictions"] == w["class_predictions"]
        assert g["any_harmful"] == w["any_harmful"]


@pytest.fixture(scope="module", params=sorted(KNOBS))
def classifiers(request, clip_checkpoint):  # noqa: F811
    mp = pytest.MonkeyPatch()
    for k, v in KNOBS[request.param].items():
        mp.setenv(k, v)
    try:
        yield th.model_fn(clip_checkpoint, device="cpu"), jh.model_fn(clip_checkpoint)
    finally:
        mp.undo()


@pytest.mark.parametrize(
    "body",
    [{"text": "hi"}, {"instances": [{"text": "a"}, {"text": "b"}]}, [{"text": "a"}], "x"],
)
def test_input_fn_matches_jax(body):
    assert th.input_fn(json.dumps(body)) == jh.input_fn(json.dumps(body))


def test_input_fn_refuses_other_content_types():
    with pytest.raises(ValueError):
        th.input_fn("{}", "text/csv")
    with pytest.raises(ValueError):
        th.output_fn([], "text/csv")


def test_predict_fn_matches_jax(classifiers):
    tc, jc = classifiers
    insts = instances()
    assert len(insts) > tc.batch_size  # two batches, the last one padded
    got, want = th.predict_fn(insts, tc), jh.predict_fn(insts, jc)
    _same(got, want)
    _same(json.loads(th.output_fn(got))["predictions"], json.loads(jh.output_fn(want))["predictions"])


def test_predict_fn_with_a_device_lock(classifiers):
    tc, _ = classifiers
    insts = instances(5)
    _same(th.predict_fn(insts, tc, device_lock=threading.Lock()), th.predict_fn(insts, tc))


def test_batch_transform_matches_jax(classifiers, tmp_path):
    tc, jc = classifiers
    lines = [json.dumps(i) for i in instances(6)]
    lines[2:2] = ["", "{bad json"]
    src = tmp_path / "in.jsonl"
    src.write_text("\n".join(lines))
    th.BatchTransformHandler(tc).process_file(str(src), str(tmp_path / "t.jsonl"))
    jh.BatchTransformHandler(jc).process_file(str(src), str(tmp_path / "j.jsonl"))
    got = [json.loads(x) for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    want = [json.loads(x) for x in (tmp_path / "j.jsonl").read_text().splitlines()]
    assert len(got) == len(want) == 7
    assert got[2] == want[2] and "error" in got[2]
    _same(got[:2] + got[3:], want[:2] + want[3:])


def test_model_fn_knobs(clip_checkpoint, monkeypatch):  # noqa: F811
    monkeypatch.setenv("MMHARM_ENGINE", "fast")
    monkeypatch.setenv("MMHARM_SEQ_BUCKETS", "off")
    monkeypatch.setenv("MMHARM_PREWARM", "0")
    clf = th.model_fn(clip_checkpoint, device="cpu")
    assert clf.engine is not None and clf._bucket_ladder is None
    monkeypatch.setenv("MMHARM_PRECISION", "int8_mlp")
    clf = th.model_fn(clip_checkpoint, device="cpu")
    assert clf.quantized_layers == 0  # 32-wide towers: no (768, 3072) fc1
    assert clf.model.encoder_config.text.compute_dtype == "bfloat16"


def test_local_test_main(clip_checkpoint, capsys):  # noqa: F811
    image = str(next(iter(jpeg_fixtures().values())))
    th._local_test_main(["--model-dir", clip_checkpoint, "--image", image, "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(out["predictions"]) == 1


# -- the HTTP server ---------------------------------------------------------


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def server(clip_checkpoint):  # noqa: F811
    mp = pytest.MonkeyPatch()
    for k, v in KNOBS["fast"].items():
        mp.setenv(k, v)
    s = srv.serve(clip_checkpoint, port=0, host="127.0.0.1", device="cpu")
    threading.Thread(target=s.serve_forever, daemon=True).start()
    try:
        yield s, f"http://127.0.0.1:{s.server_address[1]}"
    finally:
        s.shutdown()
        s.server_close()
        mp.undo()


def test_ping_after_the_model_is_warm(server):
    s, url = server
    assert s.state.classifier is not None
    with urllib.request.urlopen(f"{url}/ping", timeout=30) as r:
        assert r.status == 200


def test_single_and_batch_invocations_match_predict_fn(server, clip_checkpoint):  # noqa: F811
    s, url = server
    insts = instances(12)
    want = jh.predict_fn(insts, jh_classifier(clip_checkpoint))
    got = _post(f"{url}/invocations", json.dumps({"instances": insts}).encode())
    _same(got["predictions"], want)
    single = _post(f"{url}/invocations", json.dumps(insts[0]).encode())
    _same(single["predictions"], want[:1])


_JAX = {}


def jh_classifier(ckpt):
    """The JAX endpoint's classifier with the server's knobs (one per run)."""
    if ckpt not in _JAX:
        mp = pytest.MonkeyPatch()
        for k, v in KNOBS["fast"].items():
            mp.setenv(k, v)
        try:
            _JAX[ckpt] = jh.model_fn(ckpt)
        finally:
            mp.undo()
    return _JAX[ckpt]


@pytest.mark.parametrize("window", [None, "50"])
def test_concurrent_requests_get_their_own_rows(server, monkeypatch, window):
    """Host preparation runs outside the device lock (or requests coalesce
    in the micro-batcher): every concurrent answer equals its own
    sequential one, and the requests' answers differ from each other."""
    s, url = server
    if window:
        monkeypatch.setenv("MMHARM_MICROBATCH_MS", window)
    else:
        monkeypatch.delenv("MMHARM_MICROBATCH_MS", raising=False)
    srv.configure(s.state)
    try:
        insts = instances(16)
        bodies = [json.dumps({"instances": insts[2 * k: 2 * k + 2]}).encode() for k in range(8)]
        sequential = [_probs(_post(f"{url}/invocations", b)["predictions"]) for b in bodies]
        results = [None] * len(bodies)

        def worker(k):
            results[k] = _probs(_post(f"{url}/invocations", bodies[k])["predictions"])

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for k, (seq, conc) in enumerate(zip(sequential, results)):
            np.testing.assert_allclose(conc, seq, atol=ATOL, rtol=0)
            others = [np.abs(conc - o).max() for j, o in enumerate(sequential) if j != k]
            assert min(others) > 10 * ATOL
    finally:
        monkeypatch.delenv("MMHARM_MICROBATCH_MS", raising=False)
        srv.configure(s.state)


def test_bad_body_is_400_and_unknown_route_404(server):
    _, url = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/invocations", b"{not json")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/nope", timeout=30)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{url}/elsewhere", b"{}")
    assert e.value.code == 404
    with urllib.request.urlopen(f"{url}/ping", timeout=30) as r:
        assert r.status == 200


def test_model_failure_is_500_not_400():
    from http.server import ThreadingHTTPServer

    state = srv._State()
    state.classifier = object()

    def exploding(instances):
        raise RuntimeError("device fault")

    state.batcher = exploding
    s = ThreadingHTTPServer(("127.0.0.1", 0), srv._make_request_handler(state))
    threading.Thread(target=s.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{s.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/invocations", json.dumps({"text": "hello"}).encode())
        assert e.value.code == 500
        assert "device fault" in json.loads(e.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as e2:
            _post(f"{url}/invocations", b"{not json")
        assert e2.value.code == 400
        state.classifier = None
        with pytest.raises(urllib.error.HTTPError) as e3:
            urllib.request.urlopen(f"{url}/ping", timeout=30)
        assert e3.value.code == 503
    finally:
        s.shutdown()
        s.server_close()


def test_a_decoder_fault_is_500(server, monkeypatch):
    """A JPEG decode that fails for the machine's sake (here: a copy from the
    card) fails the request; the post is not scored as text alone."""
    from multimodal_content_moderation_tpu_torch.data import native

    s, url = server
    preproc = s.state.classifier.preproc
    backend, preproc.backend = preproc.backend, "native_scaled"

    class Faulty:
        def decode_jpeg_resize_crop_u8(self, *args):
            return 5

    monkeypatch.setattr(native, "load", lambda: Faulty())
    try:
        inst = {"text": "hello", "image": base64.b64encode(
            jpeg_fixtures()["rgb420_240x320"].read_bytes()).decode()}
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(f"{url}/invocations", json.dumps(inst).encode())
        assert e.value.code == 500
        assert "code 5" in json.loads(e.value.read())["error"]
    finally:
        preproc.backend = backend


# -- MicroBatcher (the JAX tests' cases) ----------------------------------------


def test_configure_closes_the_previous_batcher(monkeypatch):
    """Each configure() stops the batcher it replaces (its worker thread
    ends); a request that still holds the old batcher runs inline."""
    state = srv._State()
    state.classifier = object()
    monkeypatch.setenv("MMHARM_MICROBATCH_MS", "5")
    srv.configure(state)
    first = state.batcher
    srv.configure(state)
    assert state.batcher is not first and not first._worker.is_alive()
    assert state.batcher._worker.is_alive()
    first._predict = lambda insts: [{"echo": i["x"]} for i in insts]
    assert first([{"x": 3}]) == [{"echo": 3}]
    second = state.batcher
    monkeypatch.delenv("MMHARM_MICROBATCH_MS")
    srv.configure(state)
    assert state.batcher is None and not second._worker.is_alive()


def test_microbatcher_coalesces_and_routes():
    calls = []

    def predict(insts):
        calls.append(len(insts))
        return [{"echo": i["x"]} for i in insts]

    mb = srv.MicroBatcher(predict, window_ms=60.0, max_batch=64)
    results = {}

    def client(cid):
        results[cid] = mb([{"x": f"{cid}-0"}, {"x": f"{cid}-1"}])

    threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(results) == 4
    for cid, out in results.items():
        assert [o["echo"] for o in out] == [f"{cid}-0", f"{cid}-1"]
    assert len(calls) < 4 and max(calls) > 2


def test_microbatcher_bypasses_large_requests():
    seen = []

    def predict(insts):
        seen.append((threading.current_thread(), len(insts)))
        return [{"echo": i["x"]} for i in insts]

    mb = srv.MicroBatcher(predict, window_ms=20.0, max_batch=64, bypass_n=4)
    big = [{"x": i} for i in range(6)]
    assert [o["echo"] for o in mb(big)] == list(range(6))
    assert seen[-1] == (threading.current_thread(), 6)
    assert mb([{"x": "s"}]) == [{"echo": "s"}]
    assert seen[-1][0] is not threading.current_thread()
    mb0 = srv.MicroBatcher(predict, window_ms=5.0, bypass_n=0)
    mb0(big)
    assert seen[-1][0] is not threading.current_thread()


def test_microbatcher_fans_an_error_out():
    def predict(insts):
        raise RuntimeError("device fell over")

    mb = srv.MicroBatcher(predict, window_ms=30.0)
    errs = []

    def client():
        try:
            mb([{"x": 1}])
        except RuntimeError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=client) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert errs == ["device fell over"] * 3


def test_a_burst_of_connections_is_served():
    """64 clients connect at once to a slow model: every request gets its
    200, none is reset or refused (the standard library's backlog of 5,
    which the JAX server keeps, resets such a burst's extra connections)."""
    state = srv._State()
    state.classifier = object()

    def slow(instances):
        import time

        time.sleep(0.2)
        return [{"probabilities": {}, "class_predictions": {}, "any_harmful": False}
                for _ in instances]

    state.batcher = slow
    s = srv.Server(("127.0.0.1", 0), srv._make_request_handler(state))
    assert s.request_queue_size >= 64
    threading.Thread(target=s.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{s.server_address[1]}/invocations"
    statuses = []

    def client():
        try:
            _post(url, json.dumps({"text": "x"}).encode(), timeout=60)
            statuses.append(200)
        except OSError as e:
            statuses.append(repr(e))

    try:
        threads = [threading.Thread(target=client) for _ in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert statuses == [200] * 64
    finally:
        s.shutdown()
        s.server_close()
