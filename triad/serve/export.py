"""AOT model export for serving (jax.export / StableHLO).

The reference deploys by shipping the torch repo + checkpoint and
re-running model code. This serving path compiles the inference
surface ONCE and ships a self-contained bundle — no model code, no
checkpoint restore at serving time:

  bundle/
    meta.json              shapes, dtypes, temperature, model config
    vocab.txt              WordPiece vocab (text endpoint tokenization)
    embed_audio.stablehlo  (b, T) waveform      -> (b, Na, D) tokens
    embed_visual.stablehlo (b, H, W, 3) frames  -> (b, Nv, D) tokens
    embed_text.stablehlo   (b, Nt) ids + mask   -> (b, Nt, D) tokens
    pair_scores.stablehlo  (q, Nq, D) x (k, Nk, D) tokens -> (q, k) scores

Each ``.stablehlo`` file is the StableHLO bytecode of a
``jax.export.Exported``; its calling metadata (symbolic shapes, dtypes,
platforms, calling convention) sits in meta.json under "functions".
``Exported.serialize`` would need the ``flatbuffers`` package, which
GPU images do not always ship.

Every function is exported with a SYMBOLIC batch dimension
(jax.export shape polymorphism), so one bundle serves any batch size,
and lowered for BOTH the cpu and cuda platforms. Parameters are burned
into the module as constants (train=False, dropout dead). Attention is
forced to the XLA path: the Pallas kernel has no cpu lowering and would
pin the bundle to one platform.

``pair_scores`` is the retrieval aggregator (reference
retrieval.py:106-115 semantics: token sims / temperature, max over
candidate tokens, masked mean over query tokens). Normalization
conventions stay the CALLER's job, matching eval/retrieval.py: L2 over
AV features, raw TV features; the server (serve/server.py) applies
them per direction.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np


def _pair_scores_fn(q_tokens, q_mask, k_tokens, k_mask, inv_temp):
    """(q, Nq, D), (q, Nq), (k, Nk, D), (k, Nk) -> (q, k) max-mean."""
    import jax.numpy as jnp

    sims = jnp.einsum(
        "qnd,kmd->qnkm", q_tokens, k_tokens,
        preferred_element_type=jnp.float32,
    ) * inv_temp
    neg = jnp.finfo(jnp.float32).min
    sims = jnp.where(k_mask[None, None, :, :] > 0, sims, neg)
    mx = jnp.max(sims, axis=3)  # (q, Nq, k)
    counts = jnp.maximum(jnp.sum(q_mask, axis=1), 1.0)  # (q,)
    return jnp.sum(mx * q_mask[:, :, None], axis=1) / counts[:, None]


def export_bundle(
    params: Any,
    model_cfg,
    out_dir: str,
    *,
    audio_num_samples: int,
    max_text_tokens: int,
    vocab: Optional[Dict[str, int]] = None,
    int8: bool = False,
    platforms=("cpu", "cuda"),
) -> Path:
    """Serialize the serving surface of ``params`` to ``out_dir``."""
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    from triad.models import TriadModel

    model_cfg = dataclasses.replace(model_cfg, **{
        name: dataclasses.replace(getattr(model_cfg, name), attention_impl="xla")
        for name in ("vit", "hubert", "text")
    })
    model = TriadModel(model_cfg)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def apply(method, *args):
        if int8:
            from triad.models.quantize import int8_interception

            with int8_interception():
                return model.apply(
                    {"params": params}, *args, train=False, method=method
                )
        return model.apply(
            {"params": params}, *args, train=False, method=method
        )

    H = model_cfg.vit.image_size
    Nt = max_text_tokens
    (b,) = jexport.symbolic_shape("b")
    f32 = jnp.float32

    def spec(*shape, dtype=f32):
        return jax.ShapeDtypeStruct(shape, dtype)

    funcs = {
        "embed_audio": (
            lambda audio: apply(TriadModel.encode_audio, audio),
            (spec(b, audio_num_samples),),
        ),
        "embed_visual": (
            lambda images: apply(TriadModel.encode_visual, images),
            (spec(b, H, H, 3),),
        ),
        "embed_text": (
            lambda ids, mask: apply(TriadModel.encode_text, ids, mask),
            (spec(b, Nt, dtype=jnp.int32), spec(b, Nt)),
        ),
    }
    functions = {}
    for name, (fn, in_specs) in funcs.items():
        exp = jexport.export(jax.jit(fn), platforms=list(platforms))(*in_specs)
        functions[name] = _write_exported(out, name, exp)

    # one scope for all four symbolic dims (batch sizes AND token
    # lengths both free — scores work on any token-length pair)
    q, k, nq, nk = jexport.symbolic_shape("q, k, nq, nk")
    d = model_cfg.embedding_dim
    exp = jexport.export(
        jax.jit(_pair_scores_fn), platforms=list(platforms)
    )(
        spec(q, nq, d), spec(q, nq), spec(k, nk, d), spec(k, nk),
        jax.ShapeDtypeStruct((), f32),
    )
    functions["pair_scores"] = _write_exported(out, "pair_scores", exp)

    if vocab:
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        (out / "vocab.txt").write_text(
            "\n".join(t for t, _ in ordered) + "\n", encoding="utf-8"
        )

    meta = {
        "format": "triad.serve/2",
        "platforms": list(platforms),
        "int8": int8,
        "temperature": float(np.asarray(params["temperature"])),
        "embedding_dim": d,
        "audio_num_samples": audio_num_samples,
        "image_size": H,
        "max_text_tokens": Nt,
        "model_config": _cfg_dict(model_cfg),
        "functions": functions,
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=2))
    return out


def _avals_meta(avals):
    return [[",".join(str(d) for d in a.shape), a.dtype.name] for a in avals]


def _write_exported(out: Path, name: str, exp) -> Dict[str, Any]:
    """Write ``exp``'s bytecode to ``<name>.stablehlo``; return the
    metadata ``_read_exported`` rebuilds it from. Bundles hold
    single-device, effect-free functions of positional arrays returning
    one array."""
    import jax

    if (exp.nr_devices != 1 or exp.ordered_effects or exp.unordered_effects
            or exp.disabled_safety_checks or exp.out_tree.num_leaves != 1
            or exp.in_tree != jax.tree.structure(
                (tuple(range(len(exp.in_avals))), {}))):
        raise ValueError(f"{name}: not a single-device positional function")
    (out / f"{name}.stablehlo").write_bytes(exp.mlir_module_serialized)
    return {
        "in_avals": _avals_meta(exp.in_avals),
        "out_avals": _avals_meta(exp.out_avals),
        "platforms": list(exp.platforms),
        "calling_convention_version": exp.calling_convention_version,
        "module_kept_var_idx": list(exp.module_kept_var_idx),
        "uses_global_constants": exp.uses_global_constants,
    }


def _read_exported(path: Path, name: str, meta: Dict[str, Any]):
    import jax
    from jax import export as jexport

    scope = jexport.SymbolicScope()

    def avals(entries):
        return tuple(
            jax.core.ShapedArray(
                jexport.symbolic_shape(shape, scope=scope) if shape else (),
                np.dtype(dtype) if dtype != "bfloat16"
                else jax.numpy.bfloat16,
            )
            for shape, dtype in entries
        )

    in_avals, out_avals = avals(meta["in_avals"]), avals(meta["out_avals"])
    n_in, n_out = len(in_avals), len(out_avals)
    return jexport.Exported(
        fun_name=name,
        in_tree=jax.tree.structure((tuple(range(n_in)), {})),
        in_avals=in_avals,
        out_tree=jax.tree.structure(0),
        out_avals=out_avals,
        _has_named_shardings=True,
        _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * n_out,
        in_shardings_hlo=(None,) * n_in,
        out_shardings_hlo=(None,) * n_out,
        nr_devices=1,
        platforms=tuple(meta["platforms"]),
        ordered_effects=(),
        unordered_effects=(),
        disabled_safety_checks=(),
        mlir_module_serialized=(path / f"{name}.stablehlo").read_bytes(),
        calling_convention_version=meta["calling_convention_version"],
        module_kept_var_idx=tuple(meta["module_kept_var_idx"]),
        uses_global_constants=meta["uses_global_constants"],
        _get_vjp=None,
    )


def _cfg_dict(model_cfg) -> Dict[str, Any]:
    import dataclasses

    return dataclasses.asdict(model_cfg)


class ServingBundle:
    """Loaded export bundle: callable endpoints, no model code needed."""

    def __init__(self, path: str):
        import jax

        self.path = Path(path)
        self.meta = json.loads((self.path / "meta.json").read_text())
        self.exported = {
            name: _read_exported(self.path, name, meta)
            for name, meta in self.meta["functions"].items()
        }
        # jit around .call caches the per-shape refinements
        self._fns = {n: jax.jit(e.call) for n, e in self.exported.items()}
        vocab_file = self.path / "vocab.txt"
        self.tokenizer = None
        if vocab_file.exists():
            from triad.data.tokenizer import WordPieceTokenizer

            self.tokenizer = WordPieceTokenizer.from_vocab_file(
                str(vocab_file)
            )

    # Token features leave as float32 whatever the compute dtype: bf16
    # has no portable .npy or JSON form.
    def embed_audio(self, audio: np.ndarray) -> np.ndarray:
        return np.asarray(
            self._fns["embed_audio"](np.asarray(audio, np.float32)),
            np.float32,
        )

    def embed_visual(self, images: np.ndarray) -> np.ndarray:
        return np.asarray(
            self._fns["embed_visual"](np.asarray(images, np.float32)),
            np.float32,
        )

    def embed_text_ids(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        return np.asarray(
            self._fns["embed_text"](
                np.asarray(ids, np.int32), np.asarray(mask, np.float32)
            ),
            np.float32,
        )

    def embed_texts(self, texts) -> Dict[str, np.ndarray]:
        if self.tokenizer is None:
            raise ValueError("bundle has no vocab.txt — pass token ids")
        n = self.meta["max_text_tokens"]
        ids, mask = self.tokenizer.encode_batch(
            list(texts), max_length=n, pad_to=n
        )
        return {
            "tokens": self.embed_text_ids(ids, mask),
            "mask": np.asarray(mask, np.float32),
        }

    def pair_scores(
        self, q_tokens, q_mask, k_tokens, k_mask,
        temperature: Optional[float] = None,
    ) -> np.ndarray:
        temp = self.meta["temperature"] if temperature is None else temperature
        return np.asarray(
            self._fns["pair_scores"](
                np.asarray(q_tokens, np.float32),
                np.asarray(q_mask, np.float32),
                np.asarray(k_tokens, np.float32),
                np.asarray(k_mask, np.float32),
                np.float32(1.0 / temp),
            )
        )
