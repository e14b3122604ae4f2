"""``chip_smoke.py`` keeps numpy copies of ``benchmarks/tpch.py``'s data
generator and query texts (that module needs pandas, which the card's
machine lacks).  The copies must stay equal to the originals, and its
sqlite oracle and answer checks must agree with the port on the CPU."""
import torch

import chip_smoke
from benchmarks.tpch import QUERIES, generate_tpch


def test_query_texts_are_the_benchmarks():
    assert chip_smoke.QUERIES == QUERIES


def test_generator_matches_the_benchmarks():
    want = generate_tpch(0.002, seed=3)
    got = chip_smoke.generate_tpch(0.002, seed=3)
    assert list(got) == list(want)
    for name, df in want.items():
        assert list(got[name]) == list(df.columns), name
        for col in df.columns:
            w, g = df[col], got[name][col]
            if w.dtype.kind == "M":
                assert (g.astype("datetime64[ns]") == w.to_numpy()).all(), col
            else:
                assert g.tolist() == w.tolist(), col


def test_sqlite_oracle_agrees_with_the_port_on_the_cpu():
    tables = chip_smoke.generate_tpch(0.002, seed=0)
    ctx, _ = chip_smoke.register(torch.device("cpu"), tables)
    conn = chip_smoke.load_sqlite(tables)
    for qid in (3, 7, 13, 22):
        q = chip_smoke.QUERIES[qid]
        chip_smoke.check_sqlite(f"Q{qid}", ctx.sql(q),
                                conn.execute(chip_smoke.to_sqlite(q)),
                                "ORDER BY" in q)
    conn.close()
    want = chip_smoke.oracle_q1(tables["lineitem"])
    got = {k: v.tolist() for k, v in ctx.sql(chip_smoke.QUERIES[1]).to_numpy().items()}
    chip_smoke.check_answer("Q1", got, want)
