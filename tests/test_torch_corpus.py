"""The port's trace corpus and parallel replay (``repro_torch.corpus``)
against the JAX package's (``repro.corpus``).

Reseeding the corpus with the port writes every committed trace of
``tests/corpus`` and its ``manifest.json`` byte for byte; the corpus
runner is clean on the committed corpus and gives the reference's
per-entry verdicts, in process and through a spawn pool of two; sharded
replay is stat-identical to the reference's serial replay; the shard
equivalence section of the corpus bench passes; and a tampered trace is
caught.
"""
import json
import os
import shutil

import pytest

from repro import corpus as jax_corpus
from repro_torch import corpus
from repro_torch.corpus import CorpusStore, InlinePool, ReplayPool
from repro_torch.workloads import corpusbench

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS_ROOT = os.path.join(HERE, "corpus")
FILES = sorted(os.listdir(CORPUS_ROOT))
with open(os.path.join(CORPUS_ROOT, "manifest.json"), encoding="utf-8") as _f:
    ENTRIES = [e["id"] for e in json.load(_f)["entries"]]


@pytest.fixture(scope="module")
def reseeded(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    corpus.seed_corpus(root, modes=("fifo", "linear", "leaky_umq"),
                       size="smoke", seed=0)
    return root


@pytest.fixture(scope="module")
def store():
    return CorpusStore.load(CORPUS_ROOT)


def test_reseeded_corpus_has_the_committed_files(reseeded):
    assert len(FILES) == 42
    assert sorted(os.listdir(reseeded)) == FILES


@pytest.mark.parametrize("name", FILES)
def test_reseeded_file_is_byte_identical(reseeded, name):
    with open(os.path.join(reseeded, name), "rb") as got, \
            open(os.path.join(CORPUS_ROOT, name), "rb") as want:
        assert got.read() == want.read()


def test_manifest_format_strings_are_the_reference():
    assert corpus.CORPUS_FORMAT == jax_corpus.CORPUS_FORMAT \
        == "repro.corpus.manifest"
    assert corpus.CORPUS_VERSION == jax_corpus.CORPUS_VERSION
    assert corpus.FAULT_CELLS == jax_corpus.FAULT_CELLS


def test_store_saves_the_committed_manifest(store, tmp_path):
    copy = CorpusStore(str(tmp_path), entries=store.entries)
    copy.save()
    with open(copy.manifest_path, "rb") as got, \
            open(store.manifest_path, "rb") as want:
        assert got.read() == want.read()


def _verdicts(result):
    return [(r.id, r.ok, r.n_ops, r.mode, r.failures, r.flags)
            for r in result.results]


@pytest.fixture(scope="module")
def reference_run():
    ref_store = jax_corpus.CorpusStore.load(CORPUS_ROOT)
    with jax_corpus.InlinePool() as pool:
        return jax_corpus.run_corpus(ref_store, pool=pool)


@pytest.mark.parametrize("pool_kind", ["inline", "spawn2"])
def test_run_corpus_is_clean_and_the_reference(store, reference_run,
                                               pool_kind):
    pool = InlinePool() if pool_kind == "inline" else ReplayPool(jobs=2)
    with pool:
        result = corpus.run_corpus(store, pool=pool)
    assert result.ok, result.failures
    assert len(result.results) == len(ENTRIES)
    assert "entries clean" in result.render()
    assert not result.report.regressed()
    assert _verdicts(result) == _verdicts(reference_run)


def test_tampered_and_missing_traces_are_caught(tmp_path):
    root = tmp_path / "corpus"
    shutil.copytree(CORPUS_ROOT, root)
    with open(root / "master_worker__fifo.jsonl", "a") as f:
        f.write("\n")
    os.remove(root / "halo3d__fifo.jsonl")
    with InlinePool() as pool:
        result = corpus.run_corpus(CorpusStore.load(str(root)), pool=pool,
                                   entries=["master_worker__fifo",
                                            "halo3d__fifo"])
    verdicts = {r.id: r for r in result.results}
    assert not result.ok
    assert any("sha256 mismatch" in f
               for f in verdicts["master_worker__fifo"].failures)
    assert any("unreadable" in f for f in verdicts["halo3d__fifo"].failures)


def test_divergent_engine_fails_loudly(store):
    with InlinePool() as pool:
        result = corpus.run_corpus(store, pool=pool, mode_override="linear",
                                   entries=["master_worker__fifo"])
    (res,) = result.results
    assert not result.ok
    assert any("signature diverges" in f for f in res.failures)
    assert "long_traversal" in res.flags and res.diff_text


@pytest.mark.parametrize("partition", ["rank", "phase"])
@pytest.mark.parametrize("entry_id", ["ring_allreduce__leaky_umq",
                                      "sparse_neighbors__linear",
                                      "halo3d__fifo__fault_drop"])
def test_parallel_replay_is_the_reference_serial_replay(store, entry_id,
                                                        partition):
    path = store.path(store.get(entry_id))
    with InlinePool() as pool:
        got = corpus.parallel_replay(path, jobs=2, partition=partition,
                                     pool=pool)
    want = jax_corpus.parallel_replay(path, jobs=1, partition=partition,
                                      pool=jax_corpus.InlinePool())
    assert got.n_ops == want.n_ops
    assert corpus.signature(got) == jax_corpus.signature(want)
    assert corpus.finding_kinds(got) == jax_corpus.finding_kinds(want)


def test_corpus_bench_shard_equivalence(store):
    with InlinePool() as pool:
        assert corpusbench.equivalence_failures(store, pool, jobs=2) == []
