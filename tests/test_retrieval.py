"""Retrieval eval tests: the vectorized masked scoring must reproduce
the reference's per-pair aggregator loop (tested against a torch oracle
over ragged token lists), plus R@K and subset persistence."""

import numpy as np
import pytest
import torch

from triad.eval import (
    compute_recall_at_k,
    score_matrix,
    select_subset_indices,
)
from tests.torch_oracle import oracle_retrieval_aggregate

N, NQ, NK, D = 12, 9, 7, 16
TEMP = 1.5


@pytest.fixture(scope="module")
def ragged_features():
    rng = np.random.default_rng(0)
    q_lens = rng.integers(2, NQ + 1, size=N)
    k_lens = rng.integers(2, NK + 1, size=N)
    q = rng.normal(size=(N, NQ, D)).astype(np.float32)
    k = rng.normal(size=(N, NK, D)).astype(np.float32)
    q_mask = (np.arange(NQ)[None] < q_lens[:, None]).astype(np.float32)
    k_mask = (np.arange(NK)[None] < k_lens[:, None]).astype(np.float32)
    q *= q_mask[..., None]
    k *= k_mask[..., None]
    return q, q_mask, k, k_mask, q_lens, k_lens


class TestScoreMatrix:
    def test_matches_per_pair_oracle(self, ragged_features):
        q, q_mask, k, k_mask, q_lens, k_lens = ragged_features
        ours = score_matrix(q, q_mask, k, k_mask, TEMP, block=5)
        ref = np.zeros((N, N), np.float32)
        for i in range(N):
            qi = torch.from_numpy(q[i, : q_lens[i]])
            for j in range(N):
                kj = torch.from_numpy(k[j, : k_lens[j]])
                ref[i, j] = oracle_retrieval_aggregate(qi, kj, TEMP)
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


class TestRecall:
    def test_perfect_diagonal(self):
        sim = np.eye(10, dtype=np.float32)
        m = compute_recall_at_k(sim)
        assert m == {"r1": 1.0, "r5": 1.0, "r10": 1.0, "r20": 1.0}

    def test_known_ranks(self):
        # item 0's correct match ranked 2nd; others 1st.
        sim = np.eye(6, dtype=np.float32)
        sim[0, 3] = 2.0
        m = compute_recall_at_k(sim)
        assert m["r1"] == pytest.approx(5 / 6)
        assert m["r5"] == 1.0


class TestSubsetPersistence:
    def test_roundtrip(self, tmp_path):
        f = str(tmp_path / "subset.json")
        s1 = select_subset_indices(100, f, subset_size=20)
        s2 = select_subset_indices(100, f, subset_size=20)
        assert s1 == s2 and len(s1) == 20


class TestATRetrieval:
    def test_transitive_direction_metrics(self, ragged_features):
        """A<->T recall: same masked aggregator, both sides ragged
        (the reference never measures this direction — README.md:15
        claims it, model.py:631-636 exposes it qualitatively)."""
        from triad.eval import at_retrieval_metrics

        q, q_mask, k, k_mask, q_lens, k_lens = ragged_features
        m = at_retrieval_metrics(q, q_mask, k, k_mask, TEMP)
        assert set(m) == {
            f"{d}_r{r}" for d in ("A->T", "T->A") for r in (1, 5, 10, 20)
        }
        # self-retrieval sanity: querying against itself is perfect
        perfect = at_retrieval_metrics(q, q_mask, q, q_mask, TEMP)
        assert perfect["A->T_r1"] == 1.0 and perfect["T->A_r1"] == 1.0
