"""HuBERT-base encoder (reference audio backbone, model.py:27-30:
``facebook/hubert-base-ls960``).

From-scratch JAX implementation matching the HF ``HubertModel`` base
computation graph (do_stable_layer_norm=False, feat_extract_norm="group",
conv_bias=False):

  7-layer conv waveform frontend (group norm on layer 0 only, GELU)
  feature projection: LayerNorm -> Dense(512 -> 768)
  conv positional embedding (kernel 128, 16 groups, weight-normed in
  torch — ported as a plain kernel) with same-pad trim + GELU
  x = x + pos; LayerNorm; 12 post-LN transformer blocks

The HF processor's per-row zero-mean/unit-var normalization over the
*padded* waveform (reference model.py:56-62 quirk — stats include the
zero padding) lives in ``normalize_waveform`` and is applied by the
caller before the conv stack.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from triad.core.config import HubertConfig
from triad.models import nn
from triad.models.layers import attention, over_batch

Dtype = Any


def normalize_waveform(audio: jax.Array) -> jax.Array:
    """Wav2Vec2FeatureExtractor zero-mean/unit-var normalization, applied
    per padded batch row (reference model.py:56-62): stats over the full
    row including zero padding, eps 1e-7 inside the sqrt."""
    audio = audio.astype(jnp.float32)
    mean = jnp.mean(audio, axis=-1, keepdims=True)
    var = jnp.var(audio, axis=-1, keepdims=True)
    return (audio - mean) / jnp.sqrt(var + 1e-7)


def _im2col_1d(x: jax.Array, kernel: int, stride: int) -> jax.Array:
    """(B, T, C) -> (B, T_out, kernel*C) windows, VALID padding.

    Built from strided slices (no gather): window position t covers rows
    [t*stride, t*stride + kernel). Turns a conv into one matmul.
    """
    B, T, C = x.shape
    t_out = (T - kernel) // stride + 1
    cols = []
    for off in range(kernel):
        end = off + (t_out - 1) * stride + 1
        cols.append(x[:, off:end:stride, :])
    return jnp.concatenate(cols, axis=-1)


class _ConvAsMatmul(nn.Module):
    """Owns nn.Conv-compatible params (kernel (k, in, out) [+ bias]) but
    evaluates as im2col + one matmul. Same param path as nn.Conv, so
    checkpoints/ports are layout-identical."""

    features: int
    kernel_size: int
    stride: int
    use_bias: bool
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        in_features = x.shape[-1]
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (self.kernel_size, in_features, self.features),
            self.param_dtype,
        )
        cols = _im2col_1d(x, self.kernel_size, self.stride)
        # im2col layout is [off0 | off1 | ...] blocks of channels, which
        # matches kernel.reshape(k*in, out) row order.
        y = jnp.dot(cols, kernel.reshape(-1, self.features).astype(self.dtype))
        if self.use_bias:
            bias = self.param(
                "bias", nn.initializers.zeros, (self.features,), self.param_dtype
            )
            y = y + bias.astype(self.dtype)
        return y


class _ConvAsBlockMatmul(nn.Module):
    """nn.Conv-compatible params, evaluated as ceil(k/s) contiguous-slice
    matmuls.

    Every window starts on a stride boundary, so reshaping the input to
    stride-sized blocks (B, nb, s*cin) makes window t = blocks
    [t, t + ceil(k/s)): y[t] = sum_i xb[t + i] @ V_i, where V_i holds
    kernel taps [i*s, min(k, (i+1)*s)) at their in-block positions and
    zeros elsewhere. Each matmul has contraction s*cin and contiguous
    operands — no strided slices (the im2col variant's weakness) and no
    (B, T, k*cin) blowup. FLOP overhead from the zero rows is
    ceil(k/s)*s/k (1.0 for k=10/s=5; 4/3 for k=3/s=2; 1.0 for k=2/s=2).
    """

    features: int
    kernel_size: int
    stride: int
    use_bias: bool
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        b, t, cin = x.shape
        k, s = self.kernel_size, self.stride
        kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (k, cin, self.features),
            self.param_dtype,
        )
        m = -(-k // s)  # ceil(k/s) block-matmuls
        t_out = (t - k) // s + 1
        nb = t_out + m - 1
        if nb * s > t:
            x = jnp.pad(x, ((0, 0), (0, nb * s - t), (0, 0)))
        xb = x[:, : nb * s].reshape(b, nb, s * cin)
        kf = kernel.astype(self.dtype)
        y = None
        for i in range(m):
            taps = kf[i * s : min(k, (i + 1) * s)]  # (<=s, cin, cout)
            if taps.shape[0] < s:
                taps = jnp.pad(taps, ((0, s - taps.shape[0]), (0, 0), (0, 0)))
            v = taps.reshape(s * cin, self.features)
            part = jnp.dot(xb[:, i : i + t_out], v)
            y = part if y is None else y + part
        if self.use_bias:
            bias = self.param(
                "bias", nn.initializers.zeros, (self.features,), self.param_dtype
            )
            y = y + bias.astype(self.dtype)
        return y


class _ChannelNorm(nn.Module):
    """Per-channel affine normalization with externally supplied
    statistics. Param layout identical to nn.GroupNorm (scale, bias), so
    ports/checkpoints are unaffected. With num_groups == channels,
    GroupNorm IS per-(batch, channel)-over-time normalization — exactly
    what this applies given full-sequence stats. setup-based so the
    phase frontend can read the affine params without applying."""

    dim: int
    epsilon: float = 1e-5
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    def setup(self):
        self.scale = self.param(
            "scale", nn.initializers.ones, (self.dim,), self.param_dtype
        )
        self.bias = self.param(
            "bias", nn.initializers.zeros, (self.dim,), self.param_dtype
        )

    def affine(self):
        return self.scale, self.bias

    def __call__(self, x: jax.Array, mean: jax.Array, var: jax.Array) -> jax.Array:
        xn = (x.astype(jnp.float32) - mean) * jax.lax.rsqrt(var + self.epsilon)
        out = xn * self.scale.astype(jnp.float32) + self.bias.astype(jnp.float32)
        return out.astype(self.dtype)


class _ConvParams(nn.Module):
    """Owns nn.Conv-identical params ({kernel}, conv_bias=False) without
    running the conv — the phase frontend consumes them directly.
    Param tree paths match nn.Conv exactly."""

    features: int
    kernel_size: int
    in_features: int
    param_dtype: Dtype = jnp.float32

    def setup(self):
        self.kernel = self.param(
            "kernel",
            nn.initializers.lecun_normal(),
            (self.kernel_size, self.in_features, self.features),
            self.param_dtype,
        )


class ConvFeatureEncoder(nn.Module):
    """(B, T) waveform -> (B, T', conv_dim[-1]) frame features.

    ``cfg.frontend_impl``: "conv" uses XLA's conv lowering (cuDNN on a
    GPU); "matmul" evaluates each layer as im2col (strided slices) + a
    single matmul; "block_matmul" as contiguous-slice block matmuls;
    "phase" as the phase-split eval frontend — same parameters, same
    numerics up to summation order.

    setup-based so ``conv0`` / ``norm`` / ``tail`` share parameters with
    ``__call__``: the chunked-remat path (HubertModel._chunked_frontend)
    splits the stack around the group norm — conv_0 is local in the
    waveform and conv_1..n are local in conv_0's output; only the
    group-norm statistics couple time steps, so they are computed in a
    separate cheap streaming pass.
    """

    cfg: HubertConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    def setup(self):
        c = self.cfg
        convs = []
        for i, (dim, k, s) in enumerate(zip(c.conv_dim, c.conv_kernel, c.conv_stride)):
            if c.frontend_impl == "block_matmul":
                convs.append(
                    _ConvAsBlockMatmul(
                        dim, k, s, use_bias=c.conv_bias, dtype=self.dtype,
                        param_dtype=self.param_dtype, name=f"conv_{i}",
                    )
                )
            elif c.frontend_impl == "matmul":
                convs.append(
                    _ConvAsMatmul(
                        dim, k, s, use_bias=c.conv_bias, dtype=self.dtype,
                        param_dtype=self.param_dtype, name=f"conv_{i}",
                    )
                )
            elif c.frontend_impl == "phase":
                if c.conv_bias:
                    raise ValueError("phase frontend: no conv bias")
                convs.append(
                    _ConvParams(
                        dim, k, in_features=1 if i == 0 else c.conv_dim[i - 1],
                        param_dtype=self.param_dtype, name=f"conv_{i}",
                    )
                )
            elif c.frontend_impl != "conv":
                raise ValueError(f"unknown frontend_impl {c.frontend_impl!r}")
            else:
                convs.append(
                    nn.Conv(
                        dim, kernel_size=(k,), strides=(s,), padding="VALID",
                        use_bias=c.conv_bias, dtype=self.dtype,
                        param_dtype=self.param_dtype, name=f"conv_{i}",
                    )
                )
        self.convs = convs
        self.group_norm = _ChannelNorm(
            c.conv_dim[0], epsilon=1e-5, dtype=self.dtype,
            param_dtype=self.param_dtype, name="group_norm",
        )

    # -- pieces (used by both the whole-sequence and chunked paths) ------

    def conv0(self, audio: jax.Array) -> jax.Array:
        """First conv, pre-norm: (B, T) -> (B, T0, dim0)."""
        return self.convs[0](audio[:, :, None].astype(self.dtype))

    @staticmethod
    def stats(y0: jax.Array):
        """Full-sequence per-(batch, channel) mean/var of conv_0 output
        (the group-norm statistics): (B, 1, C) each, fp32, biased var."""
        y = y0.astype(jnp.float32)
        mean = jnp.mean(y, axis=1, keepdims=True)
        var = jnp.mean(jnp.square(y), axis=1, keepdims=True) - jnp.square(mean)
        return mean, var

    def tail(self, y0: jax.Array, mean: jax.Array, var: jax.Array) -> jax.Array:
        """norm(with given stats) -> gelu -> conv_1..n (+gelu each)."""
        x = nn.gelu(self.group_norm(y0, mean, var), approximate=False)
        for conv in self.convs[1:]:
            x = nn.gelu(conv(x), approximate=False)
        return x

    def _phase_frontend(self, audio: jax.Array) -> jax.Array:
        """Pure-XLA phase-split matmul frontend.

        Every stride-2 conv consumes its input as two phase arrays
        (even/odd time steps) — free slices of a free reshape — so
        each layer is 2-3 plain matmuls (contraction 512) plus
        elementwise GELU, with no XLA conv lowering, no im2col widening
        (the 'matmul' impl materializes (T, K*C) windows), and no
        stride-2 gathers: a layer's (B, m, C) output
        reshapes to (B, m/2, 2C) phase-split form for free. conv_0
        (k=10, s=5) becomes two (B, T/10, 10) @ (10, C) matmuls (even /
        5-shifted odd windows) whose outputs ARE conv_1's phase inputs
        — never interleaved. GroupNorm stats come from both phase
        arrays jointly. An eval path; training keeps the chunked-remat
        conv path for backward memory."""
        c = self.cfg
        C = c.conv_dim[0]
        B, T = audio.shape
        T -= T % 10
        audio = audio[:, :T].astype(self.dtype)
        m0 = (T - 10) // 5 + 1  # conv_0 logical outputs

        w0 = self.convs[0].kernel.reshape(10, C).astype(self.dtype)
        x10a = audio.reshape(B, T // 10, 10)
        x10b = audio[:, 5 : T - 5].reshape(B, T // 10 - 1, 10)
        ye = jnp.einsum("btk,kc->btc", x10a, w0)  # even outputs
        yo = jnp.einsum("btk,kc->btc", x10b, w0)  # odd outputs
        ne, no = (m0 + 1) // 2, m0 // 2  # valid rows: 16000 / 15999
        ye = ye[:, :ne]
        yo = yo[:, :no]

        # GroupNorm (per-channel over all m0 time steps) + affine + GELU
        se = jnp.sum(ye.astype(jnp.float32), axis=1)
        so = jnp.sum(yo.astype(jnp.float32), axis=1)
        sqe = jnp.sum(jnp.square(ye.astype(jnp.float32)), axis=1)
        sqo = jnp.sum(jnp.square(yo.astype(jnp.float32)), axis=1)
        mean = (se + so) / m0  # (B, C)
        var = (sqe + sqo) / m0 - jnp.square(mean)
        g_scale, g_bias = self.group_norm.affine()
        scale = (
            g_scale.astype(jnp.float32)
            * jax.lax.rsqrt(var + self.group_norm.epsilon)
        )
        bias = g_bias.astype(jnp.float32) - mean * scale
        act = lambda x, s, b: nn.gelu(
            (x.astype(jnp.float32) * s[:, None] + b[:, None]).astype(
                self.dtype
            ),
            approximate=False,
        )
        x_e = act(ye, scale, bias)
        x_o = act(yo, scale, bias)

        t_log = m0
        y = None
        for conv in self.convs[1:]:
            k = conv.kernel_size
            w = conv.kernel.astype(self.dtype)  # (k, C, C)
            m = (t_log - k) // 2 + 1
            y = jnp.einsum("btc,cd->btd", x_e[:, :m], w[0])
            y = y + jnp.einsum("btc,cd->btd", x_o[:, :m], w[1])
            if k == 3:
                y = y + jnp.einsum(
                    "btc,cd->btd", x_e[:, 1 : m + 1], w[2]
                )
            if conv is not self.convs[-1]:
                yg = nn.gelu(y, approximate=False)
                # free phase split: pad 2 rows, reshape (B, m', 2C)
                yp = jnp.pad(yg, ((0, 0), (0, 2), (0, 0)))
                rows = (m + 2) // 2
                x2 = yp[:, : 2 * rows].reshape(B, rows, 2 * C)
                x_e = x2[..., :C]
                x_o = x2[..., C:]
            t_log = m
        return nn.gelu(y[:, :t_log], approximate=False)

    def __call__(self, audio: jax.Array) -> jax.Array:
        if self.cfg.frontend_impl == "phase":
            return self._phase_frontend(audio)
        y0 = self.conv0(audio)
        mean, var = self.stats(y0)
        return self.tail(y0, mean, var)


class _PosConvParams(nn.Module):
    """nn.Conv-identical params ({kernel, bias}, same initializers) for
    the grouped positional conv, which is evaluated outside the module
    so that it can run split over the batch (models/layers.over_batch)."""

    features: int
    kernel_size: int
    in_per_group: int
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self):
        kernel = self.param(
            "kernel", nn.initializers.lecun_normal(),
            (self.kernel_size, self.in_per_group, self.features),
            self.param_dtype,
        )
        bias = self.param(
            "bias", nn.initializers.zeros, (self.features,), self.param_dtype
        )
        return kernel, bias


def _grouped_conv(x, kernel, bias, groups: int, pad: int, dtype):
    """What nn.Conv(padding=[(pad, pad)], feature_group_count=groups)
    computes, on (B, T, C) inputs."""
    x, kernel, bias = (jnp.asarray(a, dtype) for a in (x, kernel, bias))
    y = jax.lax.conv_general_dilated(
        x, kernel, (1,), [(pad, pad)],
        dimension_numbers=jax.lax.ConvDimensionNumbers(
            (0, 2, 1), (2, 1, 0), (0, 2, 1)
        ),
        feature_group_count=groups,
    )
    return y + bias.reshape(1, 1, -1)


class PositionalConvEmbedding(nn.Module):
    cfg: HubertConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array) -> jax.Array:
        c = self.cfg
        k = c.num_conv_pos_embeddings
        g = c.num_conv_pos_embedding_groups
        kernel, bias = _PosConvParams(
            c.hidden_size, k, c.hidden_size // g,
            param_dtype=self.param_dtype, name="conv",
        )()
        h = over_batch(
            lambda _, x, w, b: _grouped_conv(x, w, b, g, k // 2, self.dtype),
            (x,), (kernel, bias),
        )
        if k % 2 == 0:
            # HubertSamePadLayer: trim the trailing element for even kernels.
            h = h[:, :-1]
        return nn.gelu(h, approximate=False)


class HubertSelfAttention(nn.Module):
    cfg: HubertConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        c = self.cfg
        head_dim = c.hidden_size // c.num_heads
        dense = lambda name: nn.Dense(
            c.hidden_size, dtype=self.dtype, param_dtype=self.param_dtype, name=name
        )
        rate = 0.0 if deterministic else c.attention_dropout
        q = dense("q_proj")(x).reshape(*x.shape[:2], c.num_heads, head_dim)
        k = dense("k_proj")(x).reshape(*x.shape[:2], c.num_heads, head_dim)
        v = dense("v_proj")(x).reshape(*x.shape[:2], c.num_heads, head_dim)
        out = attention(
            q, k, v, None, self.dtype, impl=c.attention_impl,
            scores_dtype=jnp.dtype(c.attention_scores_dtype),
            dropout_rate=rate,
            dropout_rng=self.make_rng("dropout") if rate > 0 else None,
        )
        return dense("out_proj")(out.reshape(*x.shape[:2], c.hidden_size))


class HubertEncoderLayer(nn.Module):
    """Post-LN block (HF HubertEncoderLayer, base config)."""

    cfg: HubertConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    def _residual_ln(
        self, name: str, x: jax.Array, h: jax.Array, deterministic: bool
    ) -> jax.Array:
        """LN(x + dropout(h, hidden_dropout))."""
        c = self.cfg
        drop_name = (
            "attn_out_dropout" if name == "layer_norm" else "output_dropout"
        )
        h = nn.Dropout(c.hidden_dropout, name=drop_name)(
            h, deterministic=deterministic
        )
        return nn.LayerNorm(
            epsilon=c.layer_norm_eps, dtype=self.dtype,
            param_dtype=self.param_dtype, name=name,
        )(x + h)

    @nn.compact
    def __call__(self, x: jax.Array, deterministic: bool = True) -> jax.Array:
        c = self.cfg
        attn = HubertSelfAttention(
            c, dtype=self.dtype, param_dtype=self.param_dtype, name="attention"
        )(x, deterministic=deterministic)
        x = self._residual_ln("layer_norm", x, attn, deterministic)
        h = nn.Dense(
            c.intermediate_size, dtype=self.dtype, param_dtype=self.param_dtype,
            name="intermediate_dense",
        )(x)
        h = nn.gelu(h, approximate=False)
        h = nn.Dropout(c.activation_dropout, name="intermediate_dropout")(
            h, deterministic=deterministic
        )
        h = nn.Dense(
            c.hidden_size, dtype=self.dtype, param_dtype=self.param_dtype,
            name="output_dense",
        )(h)
        return self._residual_ln("final_layer_norm", x, h, deterministic)


def _spec_augment_time_mask(
    x: jax.Array,
    masked_embed: jax.Array,
    rng: jax.Array,
    mask_prob: float,
    mask_length: int,
    min_masks: int,
) -> jax.Array:
    """HF ``_compute_mask_indices`` time masking, shape-static.

    Per batch row: the span count is ``max(min_masks,
    floor(mask_prob*T/L + U[0,1)))`` (HF's stochastic rounding), span
    starts are uniform over [0, T-L]; spans may overlap (as in HF).
    Masked positions are replaced by the learned ``masked_spec_embed``
    vector. Statically we always draw ``max_spans`` candidate spans and
    activate the first ``num_spans`` of them.
    """
    B, T, _ = x.shape
    L = min(mask_length, T)
    mean_spans = mask_prob * T / L
    max_spans = max(min_masks, int(np.ceil(mean_spans)) + 1)
    r_eps, r_start = jax.random.split(rng)
    eps = jax.random.uniform(r_eps, (B,))
    num_spans = jnp.maximum(
        min_masks, jnp.floor(mean_spans + eps).astype(jnp.int32)
    )
    starts = jax.random.randint(
        r_start, (B, max_spans), 0, max(1, T - L + 1)
    )
    active = jnp.arange(max_spans)[None, :] < num_spans[:, None]  # (B, S)
    pos = jnp.arange(T)[None, None, :]  # (1, 1, T)
    in_span = (pos >= starts[..., None]) & (pos < starts[..., None] + L)
    time_mask = jnp.any(in_span & active[..., None], axis=1)  # (B, T)
    return jnp.where(time_mask[..., None], masked_embed, x)


class HubertModel(nn.Module):
    """(B, T) normalized waveform -> (B, T', hidden) last hidden state.

    The caller is responsible for ``normalize_waveform`` (matching the
    reference's processor-inside-forward quirk, model.py:56-64).
    """

    cfg: HubertConfig
    dtype: Dtype = jnp.float32
    param_dtype: Dtype = jnp.float32

    def _chunked_frontend(self, frontend, audio: jax.Array) -> jax.Array:
        """Two-pass chunked evaluation of the conv frontend, each chunk
        under jax.checkpoint.

        The only temporal coupling in the stack is the group norm's
        full-sequence statistics, so:
          pass A streams conv_0 over waveform chunks accumulating the
          per-(batch, channel) sum / sum-of-squares (fp32 scalars per
          channel — negligible memory);
          pass B recomputes conv_0 per token block, applies the norm
          with the global stats, and runs conv_1..n (both halves are
          VALID convs => temporally local, so blocks are exact).
        Live activations drop from O(T) to O(T / n_chunks) in forward
        AND backward; numerics match the whole-sequence path (tested).
        """
        c = self.cfg
        k0, s0 = c.conv_kernel[0], c.conv_stride[0]
        T = audio.shape[1]
        t0_len = (T - k0) // s0 + 1  # conv_0 output length
        stride_tail = 1
        for s in c.conv_stride[1:]:
            stride_tail *= s
        receptive_tail = 1
        for k, s in zip(reversed(c.conv_kernel[1:]), reversed(c.conv_stride[1:])):
            receptive_tail = (receptive_tail - 1) * s + k
        total_tokens = c.num_audio_tokens(T)

        conv0_fn = nn.checkpoint(lambda mdl, a: mdl.conv0(a))
        tail_fn = nn.checkpoint(
            lambda mdl, a, m, v: mdl.tail(mdl.conv0(a), m, v)
        )

        # Pass A: streaming group-norm statistics.
        chunk0 = min(c.frontend_chunk_tokens * stride_tail, t0_len)
        total = jnp.zeros((audio.shape[0], 1, c.conv_dim[0]), jnp.float32)
        total_sq = jnp.zeros_like(total)
        u0 = 0
        while u0 < t0_len:
            u1 = min(t0_len, u0 + chunk0)
            y0 = conv0_fn(
                frontend, audio[:, u0 * s0 : (u1 - 1) * s0 + k0]
            ).astype(jnp.float32)
            total = total + jnp.sum(y0, axis=1, keepdims=True)
            total_sq = total_sq + jnp.sum(jnp.square(y0), axis=1, keepdims=True)
            u0 = u1
        mean = total / t0_len
        var = total_sq / t0_len - jnp.square(mean)

        # Pass B: normalized frontend per token block.
        chunk_t = min(c.frontend_chunk_tokens, total_tokens)
        outs = []
        t0 = 0
        while t0 < total_tokens:
            t1 = min(total_tokens, t0 + chunk_t)
            v0 = t0 * stride_tail
            v1 = (t1 - 1) * stride_tail + receptive_tail
            a0, a1 = v0 * s0, (v1 - 1) * s0 + k0
            outs.append(tail_fn(frontend, audio[:, a0:a1], mean, var))
            t0 = t1
        return jnp.concatenate(outs, axis=1)

    @nn.compact
    def __call__(self, audio: jax.Array, deterministic: bool = True) -> jax.Array:
        c = self.cfg
        # The conv-frontend activations are the device-memory hot spot of
        # the backward (bf16[B, T/5, 512] ~2 GB per layer at B=64/10 s).
        # remat="conv" checkpoints the whole frontend; the default
        # "chunked_conv" additionally exploits temporal locality: a VALID
        # conv chain maps output token t to input window
        # [t*stride_total, t*stride_total + receptive_field), so token
        # blocks are computed independently, each rematted — live memory
        # drops by the chunk factor in BOTH fwd and bwd, numerics
        # unchanged (tested vs the whole-sequence conv).
        frontend_cls = ConvFeatureEncoder
        if c.remat in ("conv", "full"):
            frontend_cls = nn.remat(ConvFeatureEncoder)
        frontend = frontend_cls(
            c, dtype=self.dtype, param_dtype=self.param_dtype,
            name="feature_extractor",
        )
        if c.remat == "chunked_conv" and c.frontend_impl != "phase":
            # Kept for eval too: the two-pass form exists for backward-pass
            # memory (conv_0 runs twice), and one program keeps train and
            # eval numerics identical.
            x = self._chunked_frontend(frontend, audio)
        else:
            x = frontend(audio)
        x = nn.LayerNorm(
            epsilon=c.layer_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
            name="feature_projection_norm",
        )(x)
        x = nn.Dense(
            c.hidden_size, dtype=self.dtype, param_dtype=self.param_dtype,
            name="feature_projection",
        )(x)
        x = nn.Dropout(c.feat_proj_dropout, name="feat_proj_dropout")(
            x, deterministic=deterministic
        )
        # SpecAugment time masking (HF modeling_hubert applies it right
        # after feature projection, before the encoder; active in the
        # reference's train forwards). The param is declared iff
        # mask_time_prob > 0 — HF's creation rule — so ported HF trees
        # match ours key-for-key.
        if c.mask_time_prob > 0:
            masked_embed = self.param(
                "masked_spec_embed",
                nn.initializers.uniform(scale=1.0),
                (c.hidden_size,),
                self.param_dtype,
            )
            if not deterministic and c.apply_spec_augment:
                x = _spec_augment_time_mask(
                    x, masked_embed.astype(x.dtype), self.make_rng("dropout"),
                    c.mask_time_prob, c.mask_time_length,
                    c.mask_time_min_masks,
                )
        pos = PositionalConvEmbedding(
            c, dtype=self.dtype, param_dtype=self.param_dtype, name="pos_conv_embed"
        )(x)
        x = x + pos
        x = nn.LayerNorm(
            epsilon=c.layer_norm_eps, dtype=self.dtype, param_dtype=self.param_dtype,
            name="encoder_layer_norm",
        )(x)
        x = nn.Dropout(c.hidden_dropout, name="encoder_dropout")(
            x, deterministic=deterministic
        )
        layer_cls = HubertEncoderLayer
        if c.remat == "full":
            # static_argnums counts the bound method's args with self=0:
            # (self, x, deterministic) -> deterministic is arg 2.
            layer_cls = nn.remat(HubertEncoderLayer, static_argnums=(2,))
        for i in range(c.num_layers):
            layer = layer_cls(
                c, dtype=self.dtype, param_dtype=self.param_dtype, name=f"layer_{i}"
            )
            y = layer(x, deterministic)
            if not deterministic and c.layerdrop > 0:
                # HF LayerDrop: the whole layer is skipped with prob p
                # per call during training (one decision for the batch).
                keep = jax.random.bernoulli(
                    self.make_rng("dropout"), 1.0 - c.layerdrop
                )
                x = jnp.where(keep, y, x)
            else:
                x = y
        return x
