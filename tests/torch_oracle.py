"""Independent torch (CPU) oracle for the reference loss math.

Implements the training-loss formulas of reference src/model.py from
the structural analysis in SURVEY.md §2.1 as an *independent check* for the
triad ops. Test-only — never imported by the framework.

Citations: AV sims model.py:370-392, AV regs 394-428, AV InfoNCE 430-472,
TV sims 490-514, TV regs 516-542, TV InfoNCE 544-593,
inference sims 355-368, retrieval aggregators retrieval.py:106-115/190-198.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def oracle_crossbatch_token_sims(q, k, temperature):
    # token_sims[i,j,a,v] = <q_i_a, k_j_v> * T  (unnormalized)
    return torch.einsum("iqd,jkd->ijqk", q, k) * temperature


def oracle_clip_sims_av(token_sims):
    return token_sims.max(dim=3).values.mean(dim=2)


def oracle_clip_sims_tv(token_sims, attention_mask):
    max_sims = token_sims.max(dim=3).values  # (B,B,Nt)
    B = token_sims.shape[0]
    mask = attention_mask.unsqueeze(1).float().expand(-1, B, -1)
    return (max_sims * mask).sum(dim=2) / mask.sum(dim=2).clamp(min=1e-7)


def oracle_infonce(clip_sims):
    B = clip_sims.shape[0]
    idx = torch.arange(B)
    l_rows = -F.log_softmax(clip_sims, dim=1)[idx, idx]
    l_cols = -F.log_softmax(clip_sims.t(), dim=1)[idx, idx]
    return (l_rows + l_cols).mean() / 2


def oracle_av_reg(token_sims, temperature):
    neg = torch.clamp(token_sims, min=-60, max=0)
    l_nonneg = (neg**2).mean()
    l_cal = torch.clamp(-torch.log(temperature), min=0) ** 2
    B = token_sims.shape[0]
    diag = torch.stack([token_sims[i, i] for i in range(B)])
    l_smooth = ((diag[:, 1:] - diag[:, :-1]) ** 2).mean()
    reg = 20 * l_cal + 0.15 * l_nonneg + 0.01 * l_smooth
    return reg, 0.01 * l_smooth


def oracle_tv_reg(token_sims, threshold, weight):
    neg = torch.clamp(token_sims, min=-20, max=0)
    l_nonneg = (neg**2).mean()
    B = token_sims.shape[0]
    pos = torch.stack([token_sims[i, i] for i in range(B)])  # (B,Nt,Nv)
    probs = F.softmax(pos, dim=-1)
    frac = probs.sum(dim=1) / probs.shape[1]
    excess = F.relu(frac - threshold)
    return 0.15 * l_nonneg + weight * (excess**2).mean()


def oracle_av_loss(audio, visual, temperature):
    ts = oracle_crossbatch_token_sims(audio, visual, temperature)
    cs = oracle_clip_sims_av(ts)
    contrastive = oracle_infonce(cs)
    reg, smooth = oracle_av_reg(ts, temperature)
    return {
        "total": contrastive + reg,
        "contrastive": contrastive,
        "reg": reg,
        "smooth": smooth,
        "clip_sims": cs,
        "token_sims": ts,
    }


def oracle_tv_loss(text, visual, mask, temperature, threshold=0.8, weight=0.01):
    ts = oracle_crossbatch_token_sims(text, visual, temperature)
    cs = oracle_clip_sims_tv(ts, mask)
    contrastive = oracle_infonce(cs)
    reg = oracle_tv_reg(ts, threshold, weight)
    return {
        "total": contrastive + reg,
        "contrastive": contrastive,
        "reg": reg,
        "clip_sims": cs,
        "token_sims": ts,
    }


def oracle_pairwise_similarity(f1, f2, temperature):
    f1 = F.normalize(f1, dim=-1)
    f2 = F.normalize(f2, dim=-1)
    return torch.bmm(f1, f2.transpose(1, 2)) * temperature


def oracle_stats(clip_sims, prefix):
    B = clip_sims.shape[0]
    pos = torch.diagonal(clip_sims)
    mask = torch.ones_like(clip_sims, dtype=torch.bool)
    mask.fill_diagonal_(0)
    neg = clip_sims[mask]
    return {
        f"{prefix}_pos_sim_mean": pos.mean().item(),
        f"{prefix}_pos_sim_std": pos.std().item(),
        f"{prefix}_neg_sim_mean": neg.mean().item(),
        f"{prefix}_neg_sim_std": neg.std().item(),
        f"{prefix}_separation": (pos.mean() - neg.mean()).item(),
        f"{prefix}_hardest_negative": neg.max().item(),
    }


def oracle_retrieval_aggregate(q_feats, k_feats, temperature):
    """retrieval.py:106-110 — per pair: (q @ k.T) / T, max over k, mean over q."""
    token_sims = torch.matmul(q_feats, k_feats.t()) / temperature
    return token_sims.max(dim=1).values.mean().item()
