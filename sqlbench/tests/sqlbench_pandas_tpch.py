# A frozen copy of the repository's hand-written pandas TPC-H queries
# (benchmarks/pandas_tpch.py when the benchmark was written): the tests'
# second, independent oracle of the plain reference, at fixed literals.
"""Hand-written pandas implementations of all 22 TPC-H queries.

This is the benchmark BASELINE: the reference executes queries as pandas
operations on dataframe partitions (dask_sql lowers Calcite plans onto
dd.DataFrame — single-partition execution IS pandas), so single-threaded
pandas on the same host is the honest stand-in for the reference's
per-partition substrate (BASELINE.md publishes no absolute numbers).

The implementations are written independently from the engine (no shared
code below the DataFrame API), so tests can also use them as a second
differential oracle against the SQLite one: agreement of three independent
executors (engine / sqlite / pandas) on 22 queries is strong evidence.

Parameter values match benchmarks/tpch.py QUERIES verbatim.
"""
from __future__ import annotations

import pandas as pd

_TS = pd.Timestamp


def _sql_sum(s):
    """SQL SUM over zero rows is NULL, not 0 (pandas' .sum() says 0)."""
    return s.sum() if len(s) else float("nan")


def q1(d):
    li = d["lineitem"]
    # narrow before copying: materializing all 16 columns of the ~98%
    # selectivity filter tripled the runtime at SF 1
    x = li.loc[li["l_shipdate"] <= _TS("1998-09-02"),
               ["l_returnflag", "l_linestatus", "l_quantity",
                "l_extendedprice", "l_discount", "l_tax"]].copy()
    x["disc_price"] = x["l_extendedprice"] * (1 - x["l_discount"])
    x["charge"] = x["disc_price"] * (1 + x["l_tax"])
    out = x.groupby(["l_returnflag", "l_linestatus"], as_index=False).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("l_extendedprice", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("l_extendedprice", "mean"),
        avg_disc=("l_discount", "mean"),
        count_order=("l_quantity", "count"))
    return out.sort_values(["l_returnflag", "l_linestatus"],
                           ignore_index=True)


def q2(d):
    p, s, ps = d["part"], d["supplier"], d["partsupp"]
    n, r = d["nation"], d["region"]
    eu = n.merge(r[r["r_name"] == "EUROPE"], left_on="n_regionkey",
                 right_on="r_regionkey")
    s_eu = s.merge(eu, left_on="s_nationkey", right_on="n_nationkey")
    ps_eu = ps.merge(s_eu, left_on="ps_suppkey", right_on="s_suppkey")
    min_cost = ps_eu.groupby("ps_partkey")["ps_supplycost"].min()
    pf = p[(p["p_size"] == 15) & p["p_type"].str.endswith("BRASS")]
    m = ps_eu.merge(pf, left_on="ps_partkey", right_on="p_partkey")
    m = m[m["ps_supplycost"] == m["ps_partkey"].map(min_cost)]
    out = m[["s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
             "s_address", "s_phone", "s_comment"]]
    return out.sort_values(
        ["s_acctbal", "n_name", "s_name", "p_partkey"],
        ascending=[False, True, True, True], ignore_index=True).head(100)


def q3(d):
    cu, od, li = d["customer"], d["orders"], d["lineitem"]
    c = cu[cu["c_mktsegment"] == "BUILDING"]
    o = od[od["o_orderdate"] < _TS("1995-03-15")]
    l = li[li["l_shipdate"] > _TS("1995-03-15")]
    m = c.merge(o, left_on="c_custkey", right_on="o_custkey").merge(
        l, left_on="o_orderkey", right_on="l_orderkey")
    m["revenue"] = m["l_extendedprice"] * (1 - m["l_discount"])
    g = m.groupby(["l_orderkey", "o_orderdate", "o_shippriority"],
                  as_index=False)["revenue"].sum()
    g = g.sort_values(["revenue", "o_orderdate"], ascending=[False, True],
                      ignore_index=True).head(10)
    return g[["l_orderkey", "revenue", "o_orderdate", "o_shippriority"]]


def q4(d):
    od, li = d["orders"], d["lineitem"]
    o = od[(od["o_orderdate"] >= _TS("1993-07-01"))
           & (od["o_orderdate"] < _TS("1993-10-01"))]
    late = li[li["l_commitdate"] < li["l_receiptdate"]]
    o = o[o["o_orderkey"].isin(late["l_orderkey"])]
    out = o.groupby("o_orderpriority", as_index=False).agg(
        order_count=("o_orderkey", "count"))
    return out.sort_values("o_orderpriority", ignore_index=True)


def q5(d):
    cu, od, li = d["customer"], d["orders"], d["lineitem"]
    s, n, r = d["supplier"], d["nation"], d["region"]
    asia = n.merge(r[r["r_name"] == "ASIA"], left_on="n_regionkey",
                   right_on="r_regionkey")
    o = od[(od["o_orderdate"] >= _TS("1994-01-01"))
           & (od["o_orderdate"] < _TS("1995-01-01"))]
    m = (o.merge(cu, left_on="o_custkey", right_on="c_custkey")
          .merge(li, left_on="o_orderkey", right_on="l_orderkey")
          .merge(s, left_on="l_suppkey", right_on="s_suppkey"))
    m = m[m["c_nationkey"] == m["s_nationkey"]]
    m = m.merge(asia, left_on="s_nationkey", right_on="n_nationkey")
    m["revenue"] = m["l_extendedprice"] * (1 - m["l_discount"])
    out = m.groupby("n_name", as_index=False)["revenue"].sum()
    return out.sort_values("revenue", ascending=False, ignore_index=True)


def q6(d):
    li = d["lineitem"]
    x = li[(li["l_shipdate"] >= _TS("1994-01-01"))
           & (li["l_shipdate"] < _TS("1995-01-01"))
           & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
           & (li["l_quantity"] < 24)]
    return pd.DataFrame(
        {"revenue": [_sql_sum(x["l_extendedprice"] * x["l_discount"])]})


def q7(d):
    s, li, od = d["supplier"], d["lineitem"], d["orders"]
    cu, n = d["customer"], d["nation"]
    fr_ge = n[n["n_name"].isin(["FRANCE", "GERMANY"])]
    l = li[(li["l_shipdate"] >= _TS("1995-01-01"))
           & (li["l_shipdate"] <= _TS("1996-12-31"))]
    m = (l.merge(s, left_on="l_suppkey", right_on="s_suppkey")
          .merge(fr_ge.rename(columns=lambda c: c + "_1"),
                 left_on="s_nationkey", right_on="n_nationkey_1")
          .merge(od, left_on="l_orderkey", right_on="o_orderkey")
          .merge(cu, left_on="o_custkey", right_on="c_custkey")
          .merge(fr_ge.rename(columns=lambda c: c + "_2"),
                 left_on="c_nationkey", right_on="n_nationkey_2"))
    m = m[((m["n_name_1"] == "FRANCE") & (m["n_name_2"] == "GERMANY"))
          | ((m["n_name_1"] == "GERMANY") & (m["n_name_2"] == "FRANCE"))]
    m = m.rename(columns={"n_name_1": "supp_nation",
                          "n_name_2": "cust_nation"})
    m["l_year"] = m["l_shipdate"].dt.year
    m["volume"] = m["l_extendedprice"] * (1 - m["l_discount"])
    out = m.groupby(["supp_nation", "cust_nation", "l_year"],
                    as_index=False).agg(revenue=("volume", "sum"))
    return out.sort_values(["supp_nation", "cust_nation", "l_year"],
                           ignore_index=True)


def q8(d):
    p, s, li, od = d["part"], d["supplier"], d["lineitem"], d["orders"]
    cu, n, r = d["customer"], d["nation"], d["region"]
    am = n.merge(r[r["r_name"] == "AMERICA"], left_on="n_regionkey",
                 right_on="r_regionkey")
    pf = p[p["p_type"] == "ECONOMY ANODIZED STEEL"]
    o = od[(od["o_orderdate"] >= _TS("1995-01-01"))
           & (od["o_orderdate"] <= _TS("1996-12-31"))]
    m = (li.merge(pf, left_on="l_partkey", right_on="p_partkey")
           .merge(o, left_on="l_orderkey", right_on="o_orderkey")
           .merge(cu, left_on="o_custkey", right_on="c_custkey")
           .merge(am[["n_nationkey"]], left_on="c_nationkey",
                  right_on="n_nationkey")
           .merge(s, left_on="l_suppkey", right_on="s_suppkey")
           .merge(n[["n_nationkey", "n_name"]].rename(
                columns={"n_nationkey": "nk2", "n_name": "nation"}),
                left_on="s_nationkey", right_on="nk2"))
    m["o_year"] = m["o_orderdate"].dt.year
    m["volume"] = m["l_extendedprice"] * (1 - m["l_discount"])
    m["brazil"] = m["volume"].where(m["nation"] == "BRAZIL", 0.0)
    g = m.groupby("o_year", as_index=False).agg(
        num=("brazil", "sum"), den=("volume", "sum"))
    g["mkt_share"] = g["num"] / g["den"]
    return g[["o_year", "mkt_share"]].sort_values(
        "o_year", ignore_index=True)


def q9(d):
    p, s, li = d["part"], d["supplier"], d["lineitem"]
    ps, od, n = d["partsupp"], d["orders"], d["nation"]
    pf = p[p["p_name"].str.contains("green", regex=False)]
    m = (li.merge(pf[["p_partkey"]], left_on="l_partkey",
                  right_on="p_partkey")
           .merge(s[["s_suppkey", "s_nationkey"]], left_on="l_suppkey",
                  right_on="s_suppkey")
           .merge(ps[["ps_partkey", "ps_suppkey", "ps_supplycost"]],
                  left_on=["l_partkey", "l_suppkey"],
                  right_on=["ps_partkey", "ps_suppkey"])
           .merge(od[["o_orderkey", "o_orderdate"]], left_on="l_orderkey",
                  right_on="o_orderkey")
           .merge(n[["n_nationkey", "n_name"]], left_on="s_nationkey",
                  right_on="n_nationkey"))
    m["o_year"] = m["o_orderdate"].dt.year
    m["amount"] = (m["l_extendedprice"] * (1 - m["l_discount"])
                   - m["ps_supplycost"] * m["l_quantity"])
    out = m.rename(columns={"n_name": "nation"}).groupby(
        ["nation", "o_year"], as_index=False).agg(
            sum_profit=("amount", "sum"))
    return out.sort_values(["nation", "o_year"], ascending=[True, False],
                           ignore_index=True)


def q10(d):
    cu, od, li, n = d["customer"], d["orders"], d["lineitem"], d["nation"]
    o = od[(od["o_orderdate"] >= _TS("1993-10-01"))
           & (od["o_orderdate"] < _TS("1994-01-01"))]
    l = li[li["l_returnflag"] == "R"]
    m = (cu.merge(o, left_on="c_custkey", right_on="o_custkey")
           .merge(l, left_on="o_orderkey", right_on="l_orderkey")
           .merge(n, left_on="c_nationkey", right_on="n_nationkey"))
    m["revenue"] = m["l_extendedprice"] * (1 - m["l_discount"])
    g = m.groupby(["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
                   "c_address", "c_comment"], as_index=False)["revenue"].sum()
    g = g.sort_values("revenue", ascending=False, ignore_index=True).head(20)
    return g[["c_custkey", "c_name", "revenue", "c_acctbal", "n_name",
              "c_address", "c_phone", "c_comment"]]


def _q11_values(d):
    ps, s, n = d["partsupp"], d["supplier"], d["nation"]
    de = s.merge(n[n["n_name"] == "GERMANY"], left_on="s_nationkey",
                 right_on="n_nationkey")
    m = ps.merge(de[["s_suppkey"]], left_on="ps_suppkey",
                 right_on="s_suppkey")
    m = m.assign(value=m["ps_supplycost"] * m["ps_availqty"])
    return m


def q11(d):
    m = _q11_values(d)
    total = m["value"].sum() * 0.0001
    g = m.groupby("ps_partkey", as_index=False)["value"].sum()
    g = g[g["value"] > total]
    return g.sort_values("value", ascending=False, ignore_index=True)


def q12(d):
    od, li = d["orders"], d["lineitem"]
    l = li[li["l_shipmode"].isin(["MAIL", "SHIP"])
           & (li["l_commitdate"] < li["l_receiptdate"])
           & (li["l_shipdate"] < li["l_commitdate"])
           & (li["l_receiptdate"] >= _TS("1994-01-01"))
           & (li["l_receiptdate"] < _TS("1995-01-01"))]
    m = l.merge(od, left_on="l_orderkey", right_on="o_orderkey")
    hi = m["o_orderpriority"].isin(["1-URGENT", "2-HIGH"])
    m = m.assign(high_line=hi.astype("int64"),
                 low_line=(~hi).astype("int64"))
    out = m.groupby("l_shipmode", as_index=False).agg(
        high_line_count=("high_line", "sum"),
        low_line_count=("low_line", "sum"))
    return out.sort_values("l_shipmode", ignore_index=True)


def q13(d):
    cu, od = d["customer"], d["orders"]
    o = od[~od["o_comment"].str.contains("special.*requests", regex=True)]
    m = cu.merge(o[["o_custkey", "o_orderkey"]], left_on="c_custkey",
                 right_on="o_custkey", how="left")
    g = m.groupby("c_custkey")["o_orderkey"].count().rename("c_count")
    out = g.groupby(g).size().rename("custdist").reset_index()
    out.columns = ["c_count", "custdist"]
    return out.sort_values(["custdist", "c_count"], ascending=[False, False],
                           ignore_index=True)


def q14(d):
    li, p = d["lineitem"], d["part"]
    l = li[(li["l_shipdate"] >= _TS("1995-09-01"))
           & (li["l_shipdate"] < _TS("1995-10-01"))]
    m = l.merge(p[["p_partkey", "p_type"]], left_on="l_partkey",
                right_on="p_partkey")
    rev = m["l_extendedprice"] * (1 - m["l_discount"])
    promo = rev.where(m["p_type"].str.startswith("PROMO"), 0.0)
    return pd.DataFrame(
        {"promo_revenue": [100.0 * promo.sum() / rev.sum()]})


def q15(d):
    li, s = d["lineitem"], d["supplier"]
    l = li[(li["l_shipdate"] >= _TS("1996-01-01"))
           & (li["l_shipdate"] < _TS("1996-04-01"))].copy()
    l["rev"] = l["l_extendedprice"] * (1 - l["l_discount"])
    r0 = l.groupby("l_suppkey", as_index=False).agg(
        total_revenue=("rev", "sum"))
    mx = r0["total_revenue"].max()
    m = s.merge(r0[r0["total_revenue"] == mx], left_on="s_suppkey",
                right_on="l_suppkey")
    out = m[["s_suppkey", "s_name", "s_address", "s_phone", "total_revenue"]]
    return out.sort_values("s_suppkey", ignore_index=True)


def q16(d):
    ps, p, s = d["partsupp"], d["part"], d["supplier"]
    bad = s[s["s_comment"].str.contains("Customer.*Complaints", regex=True)]
    pf = p[(p["p_brand"] != "Brand#45")
           & ~p["p_type"].str.startswith("MEDIUM POLISHED")
           & p["p_size"].isin([49, 14, 23, 45, 19, 3, 36, 9])]
    m = ps.merge(pf, left_on="ps_partkey", right_on="p_partkey")
    m = m[~m["ps_suppkey"].isin(bad["s_suppkey"])]
    out = m.groupby(["p_brand", "p_type", "p_size"], as_index=False).agg(
        supplier_cnt=("ps_suppkey", "nunique"))
    return out.sort_values(["supplier_cnt", "p_brand", "p_type", "p_size"],
                           ascending=[False, True, True, True],
                           ignore_index=True)


def q17(d):
    li, p = d["lineitem"], d["part"]
    pf = p[(p["p_brand"] == "Brand#23") & (p["p_container"] == "MED BOX")]
    m = li.merge(pf[["p_partkey"]], left_on="l_partkey",
                 right_on="p_partkey")
    # correlated threshold uses ALL lineitems of the part, not the joined
    # subset (same table, so the merge result is exactly lineitem-of-part)
    thresh = 0.2 * m.groupby("l_partkey")["l_quantity"].transform("mean")
    x = m[m["l_quantity"] < thresh]
    return pd.DataFrame({"avg_yearly": [_sql_sum(x["l_extendedprice"]) / 7.0]})


def q18(d):
    cu, od, li = d["customer"], d["orders"], d["lineitem"]
    big = li.groupby("l_orderkey")["l_quantity"].sum()
    big = big[big > 300]
    o = od[od["o_orderkey"].isin(big.index)]
    m = (cu.merge(o, left_on="c_custkey", right_on="o_custkey")
           .merge(li, left_on="o_orderkey", right_on="l_orderkey"))
    g = m.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                   "o_totalprice"], as_index=False).agg(
        total_qty=("l_quantity", "sum"))
    return g.sort_values(["o_totalprice", "o_orderdate"],
                         ascending=[False, True],
                         ignore_index=True).head(100)


def q19(d):
    li, p = d["lineitem"], d["part"]
    l = li[li["l_shipmode"].isin(["AIR", "AIR REG"])
           & (li["l_shipinstruct"] == "DELIVER IN PERSON")]
    m = l.merge(p, left_on="l_partkey", right_on="p_partkey")
    c1 = ((m["p_brand"] == "Brand#12")
          & m["p_container"].isin(["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
          & m["l_quantity"].between(1, 11) & m["p_size"].between(1, 5))
    c2 = ((m["p_brand"] == "Brand#23")
          & m["p_container"].isin(["MED BAG", "MED BOX", "MED PKG",
                                   "MED PACK"])
          & m["l_quantity"].between(10, 20) & m["p_size"].between(1, 10))
    c3 = ((m["p_brand"] == "Brand#34")
          & m["p_container"].isin(["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
          & m["l_quantity"].between(20, 30) & m["p_size"].between(1, 15))
    x = m[c1 | c2 | c3]
    return pd.DataFrame(
        {"revenue": [_sql_sum(x["l_extendedprice"] * (1 - x["l_discount"]))]})


def q20(d):
    s, n, ps = d["supplier"], d["nation"], d["partsupp"]
    p, li = d["part"], d["lineitem"]
    ivory = p[p["p_name"].str.startswith("ivory")]
    l = li[(li["l_shipdate"] >= _TS("1994-01-01"))
           & (li["l_shipdate"] < _TS("1995-01-01"))]
    shipped = l.groupby(["l_partkey", "l_suppkey"], as_index=False).agg(
        qty=("l_quantity", "sum"))
    m = ps.merge(ivory[["p_partkey"]], left_on="ps_partkey",
                 right_on="p_partkey")
    m = m.merge(shipped, left_on=["ps_partkey", "ps_suppkey"],
                right_on=["l_partkey", "l_suppkey"], how="left")
    # no 1994 shipments => NULL comparison is false in SQL: keep inner rows
    m = m[m["ps_availqty"] > 0.5 * m["qty"]]
    ca = s.merge(n[n["n_name"] == "CANADA"], left_on="s_nationkey",
                 right_on="n_nationkey")
    out = ca[ca["s_suppkey"].isin(m["ps_suppkey"])][["s_name", "s_address"]]
    return out.sort_values("s_name", ignore_index=True)


def q21(d):
    s, li, od, n = d["supplier"], d["lineitem"], d["orders"], d["nation"]
    sa = s.merge(n[n["n_name"] == "SAUDI ARABIA"], left_on="s_nationkey",
                 right_on="n_nationkey")
    of = od[od["o_orderstatus"] == "F"]
    # per order: number of distinct suppliers overall and among late lines
    # (drop_duplicates+size ~3x faster than groupby.nunique at SF 1)
    nsupp = (li[["l_orderkey", "l_suppkey"]].drop_duplicates()
             .groupby("l_orderkey").size())
    late = li[li["l_receiptdate"] > li["l_commitdate"]]
    nsupp_late = (late[["l_orderkey", "l_suppkey"]].drop_duplicates()
                  .groupby("l_orderkey").size())
    l1 = late.merge(sa[["s_suppkey", "s_name"]], left_on="l_suppkey",
                    right_on="s_suppkey")
    l1 = l1.merge(of[["o_orderkey"]], left_on="l_orderkey",
                  right_on="o_orderkey")
    # EXISTS l2: another supplier in the order; NOT EXISTS l3: no OTHER
    # supplier was late in the order
    l1 = l1[(l1["l_orderkey"].map(nsupp).fillna(0) > 1)
            & (l1["l_orderkey"].map(nsupp_late).fillna(0) == 1)]
    out = l1.groupby("s_name", as_index=False).agg(
        numwait=("l_orderkey", "count"))
    return out.sort_values(["numwait", "s_name"], ascending=[False, True],
                           ignore_index=True).head(100)


def q22(d):
    cu, od = d["customer"], d["orders"]
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    cc = cu["c_phone"].str[:2]
    pool = cu[cc.isin(codes)]
    avg_bal = pool[pool["c_acctbal"] > 0.0]["c_acctbal"].mean()
    x = pool[(pool["c_acctbal"] > avg_bal)
             & ~pool["c_custkey"].isin(od["o_custkey"])].copy()
    x["cntrycode"] = x["c_phone"].str[:2]
    out = x.groupby("cntrycode", as_index=False).agg(
        numcust=("c_custkey", "count"), totacctbal=("c_acctbal", "sum"))
    return out.sort_values("cntrycode", ignore_index=True)


PANDAS_QUERIES = {i: globals()[f"q{i}"] for i in range(1, 23)}
