"""Serving export + HTTP server (triad/serve): the exported
StableHLO bundle must reproduce the live model bit-close on any batch
size (symbolic batch dim), and the stdlib HTTP server must round-trip
the endpoint contract."""

import json
import threading
import urllib.request

import numpy as np
import pytest
import jax

from tests.test_multimodal import small_model_config


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    from triad.data.tokenizer import WordPieceTokenizer
    from triad.models import init_triad_model
    from triad.serve.export import ServingBundle, export_bundle

    cfg = small_model_config()
    params = init_triad_model(cfg, jax.random.key(0))
    tok = WordPieceTokenizer.build_from_corpus(
        ["a dog barking in the park", "street music and a crowd"]
    )
    out = tmp_path_factory.mktemp("serve") / "bundle"
    export_bundle(
        params, cfg, str(out),
        audio_num_samples=1600, max_text_tokens=12, vocab=tok.vocab,
        platforms=("cpu",),
    )
    return ServingBundle(str(out)), cfg, params


class TestBundle:
    @pytest.mark.parametrize("B", [1, 3])
    def test_embeddings_match_live_model(self, bundle, B):
        from triad.models import TriadModel

        b, cfg, params = bundle
        model = TriadModel(cfg)
        rng = np.random.default_rng(B)
        audio = (rng.normal(size=(B, 1600)) * 0.1).astype(np.float32)
        images = rng.normal(size=(B, 28, 28, 3)).astype(np.float32)
        ids = rng.integers(1, 90, size=(B, 12)).astype(np.int32)
        mask = np.ones((B, 12), np.float32)

        for got, method, args in (
            (b.embed_audio(audio), TriadModel.encode_audio, (audio,)),
            (b.embed_visual(images), TriadModel.encode_visual, (images,)),
            (b.embed_text_ids(ids, mask), TriadModel.encode_text, (ids, mask)),
        ):
            # jitted like the bundle: eager op-by-op execution rounds
            # differently from any compiled program.
            ref = np.asarray(jax.jit(
                lambda p, *a: model.apply(
                    {"params": p}, *a, train=False, method=method
                )
            )(params, *args))
            np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)

    def test_pair_scores_match_numpy_oracle(self, bundle):
        b, _, params = bundle
        rng = np.random.default_rng(7)
        q = rng.normal(size=(3, 5, 32)).astype(np.float32)
        qm = (rng.random((3, 5)) > 0.3).astype(np.float32)
        qm[:, 0] = 1.0
        k = rng.normal(size=(4, 6, 32)).astype(np.float32)
        km = (rng.random((4, 6)) > 0.3).astype(np.float32)
        km[:, 0] = 1.0
        temp = float(np.asarray(params["temperature"]))
        got = b.pair_scores(q, qm, k, km)

        sims = np.einsum("qnd,kmd->qnkm", q, k) / temp
        sims = np.where(km[None, None] > 0, sims, np.finfo(np.float32).min)
        mx = sims.max(axis=3)
        want = (mx * qm[:, :, None]).sum(1) / np.maximum(qm.sum(1), 1)[:, None]
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)

    def test_embed_texts_uses_bundled_vocab(self, bundle):
        b, _, _ = bundle
        out = b.embed_texts(["a dog barking", "street music"])
        assert out["tokens"].shape == (2, 12, 32)
        assert out["mask"].shape == (2, 12)
        assert out["mask"][0].sum() > 0


def test_bundle_runs_cpu_and_carries_cuda_lowering(tmp_path):
    """Bundles lower for cpu AND cuda by default: this CPU host runs the
    cpu lowering, and the cuda one travels for the GPU servers."""
    from triad.models import init_triad_model
    from triad.serve.export import ServingBundle, export_bundle

    cfg = small_model_config()
    params = init_triad_model(cfg, jax.random.key(0))
    out = export_bundle(params, cfg, str(tmp_path / "b"),
                        audio_num_samples=1600, max_text_tokens=12)
    b = ServingBundle(str(out))
    assert b.meta["platforms"] == ["cpu", "cuda"]
    for exp in b.exported.values():
        assert tuple(exp.platforms) == ("cpu", "cuda")
    tokens = b.embed_audio(np.zeros((2, 1600), np.float32))
    assert tokens.shape[0] == 2 and np.isfinite(tokens).all()


class TestServer:
    @pytest.fixture(scope="class")
    def url(self, bundle, tmp_path_factory):
        from triad.serve.server import make_server

        b, _, _ = bundle
        srv = make_server(str(b.path), port=0)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        yield f"http://127.0.0.1:{srv.server_address[1]}"
        srv.shutdown()

    def _post(self, url, path, obj):
        req = urllib.request.Request(
            url + path, data=json.dumps(obj).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())

    def test_healthz(self, url):
        with urllib.request.urlopen(url + "/healthz") as r:
            meta = json.loads(r.read())
        assert meta["status"] == "ok"
        assert meta["format"].startswith("triad.serve/")

    def test_embed_and_score_roundtrip(self, bundle, url):
        b, _, _ = bundle
        rng = np.random.default_rng(3)
        audio = (rng.normal(size=(2, 1600)) * 0.1).tolist()
        images = rng.normal(size=(2, 28, 28, 3)).tolist()
        a = self._post(url, "/v1/embed/audio", {"audio": audio})["tokens"]
        v = self._post(url, "/v1/embed/image", {"images": images})["tokens"]
        np.testing.assert_allclose(
            np.asarray(a), b.embed_audio(np.asarray(audio)),
            rtol=1e-6, atol=1e-6,
        )
        s = self._post(
            url, "/v1/score",
            {
                "query": {"tokens": a, "mask": np.ones((2, len(a[0]))).tolist()},
                "key": {"tokens": v, "mask": np.ones((2, len(v[0]))).tolist()},
                "direction": "av",
            },
        )["scores"]
        assert np.asarray(s).shape == (2, 2)
        # retrieval-parity: diagonal of identical embeddings dominates
        # after L2 normalization of a vs itself
        s_self = self._post(
            url, "/v1/score",
            {
                "query": {"tokens": a, "mask": np.ones((2, len(a[0]))).tolist()},
                "key": {"tokens": a, "mask": np.ones((2, len(a[0]))).tolist()},
                "direction": "av",
            },
        )["scores"]
        s_self = np.asarray(s_self)
        assert (np.argmax(s_self, axis=1) == np.arange(2)).all()

    def test_text_endpoint_and_errors(self, url):
        out = self._post(url, "/v1/embed/text", {"texts": ["a dog"]})
        assert np.asarray(out["tokens"]).shape == (1, 12, 32)
        req = urllib.request.Request(
            url + "/v1/score", data=b"{}",
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 400


@pytest.mark.slow
def test_export_cli_random_init(tmp_path):
    from triad.cli.export import main
    from triad.serve.export import ServingBundle

    # tiny config on disk so the CLI path exercises config loading
    cfg_file = tmp_path / "cfg.json"
    from tests.test_trainer import tiny_config

    cfg_file.write_text(json.dumps(tiny_config(tmp_path).to_dict()))
    out = tmp_path / "bundle"
    main([
        "--random-init", "--config", str(cfg_file), "--out", str(out),
        "--platforms", "cpu",
    ])
    b = ServingBundle(str(out))
    tokens = b.embed_audio(np.zeros((2, 1600), np.float32))
    assert tokens.shape[0] == 2 and np.isfinite(tokens).all()


def test_int8_bundle_exports_and_ranks_match(tmp_path):
    """--int8 export: Dense matmuls quantized inside the bundle; token
    features stay close enough that self-retrieval ranks match fp."""
    from triad.models import init_triad_model
    from triad.serve.export import ServingBundle, export_bundle

    cfg = small_model_config()
    params = init_triad_model(cfg, jax.random.key(0))
    fp = export_bundle(
        params, cfg, str(tmp_path / "fp"),
        audio_num_samples=1600, max_text_tokens=12, platforms=("cpu",),
    )
    q8 = export_bundle(
        params, cfg, str(tmp_path / "q8"),
        audio_num_samples=1600, max_text_tokens=12, int8=True,
        platforms=("cpu",),
    )
    bf, bq = ServingBundle(str(fp)), ServingBundle(str(q8))
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(4, 1600)) * 0.1).astype(np.float32)
    images = rng.normal(size=(4, 28, 28, 3)).astype(np.float32)

    def ranks(b):
        a, v = b.embed_audio(audio), b.embed_visual(images)
        a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
        v = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
        s = b.pair_scores(a, np.ones(a.shape[:2]), v, np.ones(v.shape[:2]))
        return np.argsort(-s, axis=1)

    assert (ranks(bf)[:, 0] == ranks(bq)[:, 0]).all()
