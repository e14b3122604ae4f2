"""The generators: the same seed gives the same data, another seed other
data, and the tables have the sizes their sources define."""
import numpy as np
import pytest
import torch

from sqlbench_helpers import CPU, tpch_data
from sqlbench.core import data as D
from sqlbench.gen import tpch


@pytest.mark.parametrize("seed", [1234567891234, 7])
def test_same_seed_same_data(seed):
    a = tpch.generate({"scale": 0.01}, seed, CPU)
    b = tpch.generate({"scale": 0.01}, seed, CPU)
    c = tpch.generate({"scale": 0.01}, seed + 1, CPU)
    assert D.digest(a) == D.digest(b)
    assert D.digest(a) != D.digest(c)


def test_tpch_row_counts():
    d = tpch_data()
    rows = {t: D.rows(c) for t, c in d.items()}
    assert rows["region"] == 5 and rows["nation"] == 25
    assert rows["supplier"] == 100 and rows["part"] == 2000
    assert rows["partsupp"] == 8000 and rows["customer"] == 1500
    assert rows["orders"] == 15000
    assert 15000 <= rows["lineitem"] <= 7 * 15000
    assert abs(rows["lineitem"] / 15000 - 4.0) < 0.1
    for table in d.values():
        n = D.rows(table)
        assert all(c.data.shape[0] == n for c in table.values())


def test_tpch_keys_and_invariants():
    d = tpch_data()
    li, o, ps = d["lineitem"], d["orders"], d["partsupp"]
    assert bool((o["o_orderkey"].data % 4 == 0).all())
    assert bool((o["o_custkey"].data % 3 != 0).all())        # Q22's holes
    pairs = set(zip(ps["ps_partkey"].data.tolist(),
                    ps["ps_suppkey"].data.tolist()))
    assert len(pairs) == ps["ps_partkey"].data.shape[0]
    line_pairs = set(zip(li["l_partkey"].data.tolist(),
                         li["l_suppkey"].data.tolist()))
    assert line_pairs <= pairs
    assert bool((li["l_receiptdate"].data > li["l_shipdate"].data).all())
    for table in d.values():
        for col in table.values():
            if col.kind == "str":
                assert list(col.dictionary) == sorted(col.dictionary)
                assert int(col.data.max()) < len(col.dictionary)


def test_tpch_derived_columns_follow_clause_4_2_3():
    """p_name is five distinct colours; prices and the order's status are
    derived from parts and lines as dbgen derives them."""
    d = tpch_data()
    p, li, o = d["part"], d["lineitem"], d["orders"]
    names = p["p_name"].dictionary[p["p_name"].data.numpy()]
    for name in names[:200]:
        words = name.split(" ")
        assert len(words) == 5 and len(set(words)) == 5
        assert set(words) <= set(tpch.COLORS)
    assert len(tpch.COLORS) == len(set(tpch.COLORS)) == 92
    pk = p["p_partkey"].data
    cents = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000)
    assert torch.equal(torch.round(p["p_retailprice"].data * 100).long(),
                       cents)
    retail = p["p_retailprice"].data[li["l_partkey"].data - 1]
    assert torch.allclose(li["l_extendedprice"].data,
                          li["l_quantity"].data * retail, rtol=0, atol=1e-6)
    okey = li["l_orderkey"].data // 4 - 1
    line = (torch.round(li["l_extendedprice"].data * 100).long()
            * torch.round(100 - li["l_discount"].data * 100).long() // 100
            * torch.round(100 + li["l_tax"].data * 100).long() // 100)
    total = torch.zeros_like(o["o_orderkey"].data).index_add_(0, okey, line)
    assert torch.equal(torch.round(o["o_totalprice"].data * 100).long(),
                       total)
    status = o["o_orderstatus"].dictionary[o["o_orderstatus"].data.numpy()]
    ls = li["l_linestatus"].dictionary[li["l_linestatus"].data.numpy()]
    for k in range(50):
        mine = set(ls[okey.numpy() == k])
        assert status[k] == (mine.pop() if len(mine) == 1 else "P")


def test_strings_helpers():
    got = D.strings("addr", D.digits(np.array([0, 7, 10, 123]), 0))
    assert got.tolist() == ["addr0", "addr7", "addr10", "addr123"]
    got = D.strings(D.digits(np.array([12, 3]), 2), "-",
                    D.digits(np.array([5, 42]), 4))
    assert got.tolist() == ["12-0005", "03-0042"]


@pytest.mark.parametrize("tid, reserve", [("q18", 4), ("q18", 1),
                                          ("q10", 4), ("q01", 1)])
def test_warm_up_value_sets_stay_out_of_the_window(tid, reserve):
    """The warm-up's value sets are never among the window's, also where
    the domain (Q18: four quantities) is no larger than the warm-up."""
    from sqlbench.core import manifest, params

    t = manifest.templates("tpch", [tid])[tid]
    d = params.draws(t, 3000000019, 1, 40, 1.0, reserve=reserve)
    warm = {x["sql"] for x in d[:reserve]}
    window = [x["sql"] for x in d[reserve:]]
    assert len(d) == 40 and not warm & set(window)
    assert len(set(window[:3])) == min(3, len(set(window)))
