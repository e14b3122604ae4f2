"""The plain reference of the 22 TPC-H templates: plain torch over the
benchmark's own columns, one function per template, in the precision given
(float64 for the reference, float32 for its control).

Each function takes the data set and the drawn values and returns the
result's columns (numpy, in SELECT order, ordered and limited as the query
says) and a few facts of the query's final aggregate: the rows that enter
it (``agg_rows``), its distinct value columns (``agg_values``) and its
groups (``groups``), which the kernel roofline reader counts bytes from.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.data import Col, Dataset, days
from .ops import (as_dates, code, count_distinct, decode, eq,
                  finish, gcount, group, gsum, host, isin, like, lookup,
                  member, null_if_empty, year)


def _agg(rows, values: int, groups: int) -> dict:
    return {"agg_rows": int(rows), "agg_values": values, "groups": int(groups)}


def _f(col: Col, dt: torch.dtype) -> torch.Tensor:
    return col.data.to(dt)


def _lit(value, dt: torch.dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(value), dtype=dt, device=like.device)


def _out(t: torch.Tensor) -> np.ndarray:
    return host(t).astype(np.float64)


def q01(d: Dataset, v: dict, dt: torch.dtype):
    li = d["lineitem"]
    m = li["l_shipdate"].data <= days(v["CUTOFF"])
    inv, (rf, ls) = group(code(li["l_returnflag"])[m],
                          code(li["l_linestatus"])[m])
    n = len(rf)
    qty, price = _f(li["l_quantity"], dt)[m], _f(li["l_extendedprice"], dt)[m]
    disc, tax = _f(li["l_discount"], dt)[m], _f(li["l_tax"], dt)[m]
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    cnt = gcount(inv, n)
    sums = [gsum(x, inv, n, dt) for x in (qty, price, disc_price, charge,
                                          disc)]
    cntf = cnt.to(dt)
    cols = [decode(li["l_returnflag"], rf), decode(li["l_linestatus"], ls),
            _out(sums[0]), _out(sums[1]), _out(sums[2]), _out(sums[3]),
            _out(sums[0] / cntf), _out(sums[1] / cntf), _out(sums[4] / cntf),
            host(cnt).astype(np.int64)]
    return finish(cols, [(0, "asc"), (1, "asc")], None), \
        _agg(int(m.sum()), 5, n)


def _region_nations(d: Dataset, region: str) -> torch.Tensor:
    r = d["region"]
    rkey = r["r_regionkey"].data[eq(r["r_name"], region)]
    return d["nation"]["n_nationkey"].data[member(
        d["nation"]["n_regionkey"].data, rkey)]


def _nation_key(d: Dataset, name: str) -> torch.Tensor:
    n = d["nation"]
    return n["n_nationkey"].data[eq(n["n_name"], name)]


def _nation_name(d: Dataset, keys: torch.Tensor) -> np.ndarray:
    n = d["nation"]
    idx, _ = lookup(n["n_nationkey"].data, keys)
    return decode(n["n_name"], n["n_name"].data[idx])


def q02(d: Dataset, v: dict, dt: torch.dtype):
    p, s, ps = d["part"], d["supplier"], d["partsupp"]
    nations = _region_nations(d, v["REGION"])
    s_in = member(s["s_nationkey"].data, nations)
    si, sfound = lookup(s["s_suppkey"].data, ps["ps_suppkey"].data)
    ps_in = sfound & s_in[si]
    cost = _f(ps["ps_supplycost"], dt)
    pk = ps["ps_partkey"].data
    inf = torch.tensor(float("inf"), dtype=dt, device=cost.device)
    n_pk = int(p["p_partkey"].data.max()) + 1
    min_cost = torch.full((n_pk,), float("inf"), dtype=dt,
                          device=cost.device).scatter_reduce_(
        0, pk[ps_in], cost[ps_in], reduce="amin")
    pi, pfound = lookup(p["p_partkey"].data, pk)
    p_ok = (p["p_size"].data == int(v["SIZE"])) & like(p["p_type"],
                                                       f"%{v['TYPE']}")
    m = ps_in & pfound & p_ok[pi] & (cost == min_cost[pk]) & (cost < inf)
    rows_s, rows_p = si[m], pi[m]
    cols = [_out(_f(s["s_acctbal"], dt)[rows_s]),
            decode(s["s_name"], s["s_name"].data[rows_s]),
            _nation_name(d, s["s_nationkey"].data[rows_s]),
            host(p["p_partkey"].data[rows_p]),
            decode(p["p_mfgr"], p["p_mfgr"].data[rows_p]),
            decode(s["s_address"], s["s_address"].data[rows_s]),
            decode(s["s_phone"], s["s_phone"].data[rows_s]),
            decode(s["s_comment"], s["s_comment"].data[rows_s])]
    return finish(cols, [(0, "desc"), (2, "asc"), (1, "asc"), (3, "asc")],
                  100), None


def q03(d: Dataset, v: dict, dt: torch.dtype):
    c, o, li = d["customer"], d["orders"], d["lineitem"]
    day = days(v["DATE"])
    c_ok = eq(c["c_mktsegment"], v["SEGMENT"])
    ci, cf = lookup(c["c_custkey"].data, o["o_custkey"].data)
    o_ok = cf & c_ok[ci] & (o["o_orderdate"].data < day)
    oi, of = lookup(o["o_orderkey"].data, li["l_orderkey"].data)
    m = of & o_ok[oi] & (li["l_shipdate"].data > day)
    rev = (_f(li["l_extendedprice"], dt) * (1 - _f(li["l_discount"], dt)))[m]
    inv, (orow,) = group(oi[m])
    sums = gsum(rev, inv, len(orow), dt)
    cols = [host(o["o_orderkey"].data[orow]), _out(sums),
            as_dates(o["o_orderdate"].data[orow]),
            host(o["o_shippriority"].data[orow])]
    return finish(cols, [(1, "desc"), (2, "asc")], 10), \
        _agg(int(m.sum()), 1, len(orow))


def q04(d: Dataset, v: dict, dt: torch.dtype):
    o, li = d["orders"], d["lineitem"]
    late = li["l_commitdate"].data < li["l_receiptdate"].data
    oi, of = lookup(o["o_orderkey"].data, li["l_orderkey"].data)
    has = torch.zeros(o["o_orderkey"].data.shape[0], dtype=torch.bool,
                      device=late.device)
    has[oi[of & late]] = True
    od = o["o_orderdate"].data
    m = (od >= days(v["DATE"])) & (od < days(v["END"])) & has
    inv, (prio,) = group(code(o["o_orderpriority"])[m])
    cnt = gcount(inv, len(prio))
    cols = [decode(o["o_orderpriority"], prio), host(cnt).astype(np.int64)]
    return finish(cols, [(0, "asc")], None), _agg(int(m.sum()), 0, len(prio))


def q05(d: Dataset, v: dict, dt: torch.dtype):
    c, o, li, s = d["customer"], d["orders"], d["lineitem"], d["supplier"]
    nations = _region_nations(d, v["REGION"])
    od = o["o_orderdate"].data
    o_ok = (od >= days(v["DATE"])) & (od < days(v["END"]))
    ci, _ = lookup(c["c_custkey"].data, o["o_custkey"].data)
    o_nat = c["c_nationkey"].data[ci]
    oi, of = lookup(o["o_orderkey"].data, li["l_orderkey"].data)
    si, sf = lookup(s["s_suppkey"].data, li["l_suppkey"].data)
    s_nat = s["s_nationkey"].data[si]
    m = of & sf & o_ok[oi] & (o_nat[oi] == s_nat) & member(s_nat, nations)
    rev = (_f(li["l_extendedprice"], dt) * (1 - _f(li["l_discount"], dt)))[m]
    inv, (nat,) = group(s_nat[m])
    sums = gsum(rev, inv, len(nat), dt)
    cols = [_nation_name(d, nat), _out(sums)]
    return finish(cols, [(1, "desc")], None), _agg(int(m.sum()), 1, len(nat))


def q06(d: Dataset, v: dict, dt: torch.dtype):
    li = d["lineitem"]
    sd = li["l_shipdate"].data
    disc = _f(li["l_discount"], dt)
    qty = _f(li["l_quantity"], dt)
    m = (sd >= days(v["DATE"])) & (sd < days(v["END"])) \
        & (disc >= _lit(v["DISC_LO"], dt, disc)) \
        & (disc <= _lit(v["DISC_HI"], dt, disc)) \
        & (qty < _lit(v["QUANTITY"], dt, qty))
    total = (_f(li["l_extendedprice"], dt)[m] * disc[m]).sum()
    return [null_if_empty(total, int(m.sum()))], \
        _agg(int(m.sum()), 1, 1)


def q07(d: Dataset, v: dict, dt: torch.dtype):
    c, o, li, s = d["customer"], d["orders"], d["lineitem"], d["supplier"]
    n1, n2 = _nation_key(d, v["NATION1"]), _nation_key(d, v["NATION2"])
    sd = li["l_shipdate"].data
    si, sf = lookup(s["s_suppkey"].data, li["l_suppkey"].data)
    oi, of = lookup(o["o_orderkey"].data, li["l_orderkey"].data)
    ci, cf = lookup(c["c_custkey"].data, o["o_custkey"].data)
    sn = s["s_nationkey"].data[si]
    cn = c["c_nationkey"].data[ci][oi]
    pair = ((sn == n1) & (cn == n2)) | ((sn == n2) & (cn == n1))
    m = sf & of & cf[oi] & pair & (sd >= days("1995-01-01")) \
        & (sd <= days("1996-12-31"))
    vol = (_f(li["l_extendedprice"], dt) * (1 - _f(li["l_discount"], dt)))[m]
    inv, (g_sn, g_cn, g_y) = group(sn[m], cn[m], year(sd[m]))
    sums = gsum(vol, inv, len(g_y), dt)
    cols = [_nation_name(d, g_sn), _nation_name(d, g_cn), host(g_y),
            _out(sums)]
    return finish(cols, [(0, "asc"), (1, "asc"), (2, "asc")], None), \
        _agg(int(m.sum()), 1, len(g_y))


def q08(d: Dataset, v: dict, dt: torch.dtype):
    p, c, o, li, s = (d["part"], d["customer"], d["orders"], d["lineitem"],
                      d["supplier"])
    nations = _region_nations(d, v["REGION"])
    target = _nation_key(d, v["NATION"])
    pi, pf = lookup(p["p_partkey"].data, li["l_partkey"].data)
    p_ok = eq(p["p_type"], v["TYPE"])
    oi, of = lookup(o["o_orderkey"].data, li["l_orderkey"].data)
    od = o["o_orderdate"].data
    ci, cf = lookup(c["c_custkey"].data, o["o_custkey"].data)
    o_ok = cf & member(c["c_nationkey"].data[ci], nations) \
        & (od >= days("1995-01-01")) & (od <= days("1996-12-31"))
    si, sf = lookup(s["s_suppkey"].data, li["l_suppkey"].data)
    m = pf & p_ok[pi] & of & o_ok[oi] & sf
    vol = (_f(li["l_extendedprice"], dt) * (1 - _f(li["l_discount"], dt)))[m]
    mine = s["s_nationkey"].data[si][m] == target
    inv, (yr,) = group(year(od[oi[m]]))
    total = gsum(vol, inv, len(yr), dt)
    part = gsum(torch.where(mine, vol, torch.zeros_like(vol)), inv, len(yr),
                dt)
    cols = [host(yr), _out(part / total)]
    return finish(cols, [(0, "asc")], None), _agg(int(m.sum()), 2, len(yr))


def _ps_index(d: Dataset, partkey: torch.Tensor, suppkey: torch.Tensor):
    ps = d["partsupp"]
    width = int(max(int(ps["ps_suppkey"].data.max()),
                    int(suppkey.max()) if suppkey.numel() else 0)) + 1
    return lookup(ps["ps_partkey"].data * width + ps["ps_suppkey"].data,
                  partkey * width + suppkey)


def q09(d: Dataset, v: dict, dt: torch.dtype):
    p, o, li, s, ps = (d["part"], d["orders"], d["lineitem"], d["supplier"],
                       d["partsupp"])
    pi, pf = lookup(p["p_partkey"].data, li["l_partkey"].data)
    p_ok = like(p["p_name"], f"%{v['COLOR']}%")
    m0 = pf & p_ok[pi]
    lpk, lsk = li["l_partkey"].data[m0], li["l_suppkey"].data[m0]
    psi, psf = _ps_index(d, lpk, lsk)
    si, sf = lookup(s["s_suppkey"].data, lsk)
    oi, of = lookup(o["o_orderkey"].data, li["l_orderkey"].data[m0])
    m = psf & sf & of
    amount = (_f(li["l_extendedprice"], dt)[m0] * (1 - _f(li["l_discount"],
                                                          dt)[m0])
              - _f(ps["ps_supplycost"], dt)[psi] * _f(li["l_quantity"],
                                                      dt)[m0])[m]
    inv, (nat, yr) = group(s["s_nationkey"].data[si][m],
                           year(o["o_orderdate"].data[oi][m]))
    sums = gsum(amount, inv, len(yr), dt)
    cols = [_nation_name(d, nat), host(yr), _out(sums)]
    return finish(cols, [(0, "asc"), (1, "desc")], None), \
        _agg(int(m.sum()), 1, len(yr))


def q10(d: Dataset, v: dict, dt: torch.dtype):
    c, o, li = d["customer"], d["orders"], d["lineitem"]
    od = o["o_orderdate"].data
    o_ok = (od >= days(v["DATE"])) & (od < days(v["END"]))
    oi, of = lookup(o["o_orderkey"].data, li["l_orderkey"].data)
    m = of & o_ok[oi] & eq(li["l_returnflag"], "R")
    ci, cf = lookup(c["c_custkey"].data, o["o_custkey"].data[oi[m]])
    rev = (_f(li["l_extendedprice"], dt) * (1 - _f(li["l_discount"], dt)))[m]
    inv, (crow,) = group(ci[cf])
    sums = gsum(rev[cf], inv, len(crow), dt)
    cols = [host(c["c_custkey"].data[crow]),
            decode(c["c_name"], c["c_name"].data[crow]), _out(sums),
            _out(_f(c["c_acctbal"], dt)[crow]),
            _nation_name(d, c["c_nationkey"].data[crow]),
            decode(c["c_address"], c["c_address"].data[crow]),
            decode(c["c_phone"], c["c_phone"].data[crow]),
            decode(c["c_comment"], c["c_comment"].data[crow])]
    return finish(cols, [(2, "desc")], 20), \
        _agg(int(cf.sum()), 1, len(crow))


def q11(d: Dataset, v: dict, dt: torch.dtype):
    s, ps = d["supplier"], d["partsupp"]
    nat = _nation_key(d, v["NATION"])
    si, sf = lookup(s["s_suppkey"].data, ps["ps_suppkey"].data)
    m = sf & member(s["s_nationkey"].data[si], nat)
    value = (_f(ps["ps_supplycost"], dt) * _f(ps["ps_availqty"], dt))[m]
    inv, (pk,) = group(ps["ps_partkey"].data[m])
    sums = gsum(value, inv, len(pk), dt)
    threshold = value.sum() * _lit(v["FRACTION"], dt, value)
    keep = sums > threshold
    cols = [host(pk[keep]), _out(sums[keep])]
    return finish(cols, [(1, "desc")], None), \
        _agg(int(m.sum()), 1, len(pk))


def q12(d: Dataset, v: dict, dt: torch.dtype):
    o, li = d["orders"], d["lineitem"]
    rd, cd, sd = (li["l_receiptdate"].data, li["l_commitdate"].data,
                  li["l_shipdate"].data)
    oi, of = lookup(o["o_orderkey"].data, li["l_orderkey"].data)
    m = of & isin(li["l_shipmode"], [v["SHIPMODE1"], v["SHIPMODE2"]]) \
        & (cd < rd) & (sd < cd) & (rd >= days(v["DATE"])) \
        & (rd < days(v["END"]))
    high_prio = isin(o["o_orderpriority"], ["1-URGENT", "2-HIGH"])[oi[m]]
    inv, (mode,) = group(code(li["l_shipmode"])[m])
    high = gsum(high_prio.to(torch.int64), inv, len(mode), torch.int64)
    low = gsum((~high_prio).to(torch.int64), inv, len(mode), torch.int64)
    cols = [decode(li["l_shipmode"], mode), host(high), host(low)]
    return finish(cols, [(0, "asc")], None), _agg(int(m.sum()), 2, len(mode))


def q13(d: Dataset, v: dict, dt: torch.dtype):
    c, o = d["customer"], d["orders"]
    ok = ~like(o["o_comment"], f"%{v['WORD1']}%{v['WORD2']}%")
    ci, cf = lookup(c["c_custkey"].data, o["o_custkey"].data)
    per_cust = torch.bincount(ci[ok & cf],
                              minlength=c["c_custkey"].data.shape[0])
    inv, (cnt,) = group(per_cust)
    dist = gcount(inv, len(cnt))
    cols = [host(cnt).astype(np.int64), host(dist).astype(np.int64)]
    return finish(cols, [(1, "desc"), (0, "desc")], None), \
        _agg(per_cust.shape[0], 0, len(cnt))


def q14(d: Dataset, v: dict, dt: torch.dtype):
    p, li = d["part"], d["lineitem"]
    sd = li["l_shipdate"].data
    m0 = (sd >= days(v["DATE"])) & (sd < days(v["END"]))
    pi, pf = lookup(p["p_partkey"].data, li["l_partkey"].data[m0])
    rev = (_f(li["l_extendedprice"], dt) * (1 - _f(li["l_discount"],
                                                   dt)))[m0][pf]
    promo = like(p["p_type"], "PROMO%")[pi[pf]]
    share = _lit(100.0, dt, rev) * torch.where(
        promo, rev, torch.zeros_like(rev)).sum() / rev.sum()
    return [null_if_empty(share, int(pf.sum()))], _agg(int(pf.sum()), 2, 1)


def q15(d: Dataset, v: dict, dt: torch.dtype):
    s, li = d["supplier"], d["lineitem"]
    sd = li["l_shipdate"].data
    m = (sd >= days(v["DATE"])) & (sd < days(v["END"]))
    rev = (_f(li["l_extendedprice"], dt) * (1 - _f(li["l_discount"], dt)))[m]
    inv, (sk,) = group(li["l_suppkey"].data[m])
    sums = gsum(rev, inv, len(sk), dt)
    top = sums == sums.max() if len(sk) else torch.zeros_like(sums,
                                                              dtype=bool)
    si, sf = lookup(s["s_suppkey"].data, sk[top])
    si = si[sf]
    cols = [host(s["s_suppkey"].data[si]),
            decode(s["s_name"], s["s_name"].data[si]),
            decode(s["s_address"], s["s_address"].data[si]),
            decode(s["s_phone"], s["s_phone"].data[si]),
            _out(sums[top][sf])]
    return finish(cols, [(0, "asc")], None), _agg(int(m.sum()), 1, len(sk))


def q16(d: Dataset, v: dict, dt: torch.dtype):
    p, s, ps = d["part"], d["supplier"], d["partsupp"]
    sizes = torch.tensor([int(x) for x in v["SIZE_LIST"]],
                         device=p["p_size"].data.device)
    p_ok = ~eq(p["p_brand"], v["BRAND"]) \
        & ~like(p["p_type"], f"{v['TYPE']}%") \
        & member(p["p_size"].data, sizes)
    bad = s["s_suppkey"].data[like(s["s_comment"], "%Customer%Complaints%")]
    pi, pf = lookup(p["p_partkey"].data, ps["ps_partkey"].data)
    m = pf & p_ok[pi] & ~member(ps["ps_suppkey"].data, bad)
    rows = pi[m]
    inv, (b, t, sz) = group(code(p["p_brand"])[rows],
                            code(p["p_type"])[rows], p["p_size"].data[rows])
    cnt = count_distinct(inv, len(sz), ps["ps_suppkey"].data[m])
    cols = [decode(p["p_brand"], b), decode(p["p_type"], t), host(sz),
            host(cnt).astype(np.int64)]
    return finish(cols, [(3, "desc"), (0, "asc"), (1, "asc"), (2, "asc")],
                  None), _agg(int(m.sum()), 1, len(sz))


def q17(d: Dataset, v: dict, dt: torch.dtype):
    p, li = d["part"], d["lineitem"]
    p_ok = eq(p["p_brand"], v["BRAND"]) & eq(p["p_container"],
                                             v["CONTAINER"])
    pi, pf = lookup(p["p_partkey"].data, li["l_partkey"].data)
    qty = _f(li["l_quantity"], dt)
    inv, (prow,) = group(pi[pf])
    avg = gsum(qty[pf], inv, len(prow), dt) / gcount(inv, len(prow)).to(dt)
    per_part = torch.zeros(p["p_partkey"].data.shape[0], dtype=dt,
                           device=qty.device)
    per_part[prow] = _lit(0.2, dt, qty) * avg
    m = pf & p_ok[pi] & (qty < per_part[pi])
    total = _f(li["l_extendedprice"], dt)[m].sum() / _lit(7.0, dt, qty)
    return [null_if_empty(total, int(m.sum()))], _agg(int(m.sum()), 1, 1)


def q18(d: Dataset, v: dict, dt: torch.dtype):
    c, o, li = d["customer"], d["orders"], d["lineitem"]
    oi, of = lookup(o["o_orderkey"].data, li["l_orderkey"].data)
    qty = gsum(_f(li["l_quantity"], dt)[of], oi[of],
               o["o_orderkey"].data.shape[0], dt)
    big = torch.nonzero(qty > _lit(v["QUANTITY"], dt, qty)).reshape(-1)
    ci, _ = lookup(c["c_custkey"].data, o["o_custkey"].data[big])
    cols = [decode(c["c_name"], c["c_name"].data[ci]),
            host(c["c_custkey"].data[ci]), host(o["o_orderkey"].data[big]),
            as_dates(o["o_orderdate"].data[big]),
            _out(_f(o["o_totalprice"], dt)[big]), _out(qty[big])]
    return finish(cols, [(4, "desc"), (3, "asc")], 100), \
        _agg(int(of.sum()), 1, o["o_orderkey"].data.shape[0])


def q19(d: Dataset, v: dict, dt: torch.dtype):
    p, li = d["part"], d["lineitem"]
    pi, pf = lookup(p["p_partkey"].data, li["l_partkey"].data)
    qty = _f(li["l_quantity"], dt)
    common = pf & isin(li["l_shipmode"], ["AIR", "AIR REG"]) \
        & eq(li["l_shipinstruct"], "DELIVER IN PERSON")
    size = p["p_size"].data[pi]
    m = torch.zeros_like(common)
    for k, containers, hi_size in (
            (1, ["SM CASE", "SM BOX", "SM PACK", "SM PKG"], 5),
            (2, ["MED BAG", "MED BOX", "MED PKG", "MED PACK"], 10),
            (3, ["LG CASE", "LG BOX", "LG PACK", "LG PKG"], 15)):
        part_ok = eq(p["p_brand"], v[f"BRAND{k}"]) \
            & isin(p["p_container"], containers)
        lo = _lit(v[f"QUANTITY{k}"], dt, qty)
        hi = _lit(v[f"QUANTITY{k}_HI"], dt, qty)
        m |= part_ok[pi] & (qty >= lo) & (qty <= hi) & (size >= 1) \
            & (size <= hi_size)
    m &= common
    rev = (_f(li["l_extendedprice"], dt) * (1 - _f(li["l_discount"], dt)))[m]
    return [null_if_empty(rev.sum(), int(m.sum()))], _agg(int(m.sum()), 1, 1)


def q20(d: Dataset, v: dict, dt: torch.dtype):
    p, s, ps, li = d["part"], d["supplier"], d["partsupp"], d["lineitem"]
    parts = p["p_partkey"].data[like(p["p_name"], f"{v['COLOR']}%")]
    sd = li["l_shipdate"].data
    lm = (sd >= days(v["DATE"])) & (sd < days(v["END"]))
    psi, psf = _ps_index(d, li["l_partkey"].data[lm],
                         li["l_suppkey"].data[lm])
    n_ps = ps["ps_partkey"].data.shape[0]
    qty = gsum(_f(li["l_quantity"], dt)[lm][psf], psi[psf], n_ps, dt)
    seen = torch.bincount(psi[psf], minlength=n_ps) > 0     # NULL sum: none
    ps_ok = member(ps["ps_partkey"].data, parts) & seen \
        & (_f(ps["ps_availqty"], dt) > _lit(0.5, dt, qty) * qty)
    supp = ps["ps_suppkey"].data[ps_ok]
    m = member(s["s_suppkey"].data, supp) & member(
        s["s_nationkey"].data, _nation_key(d, v["NATION"]))
    cols = [decode(s["s_name"], s["s_name"].data[m]),
            decode(s["s_address"], s["s_address"].data[m])]
    return finish(cols, [(0, "asc")], None), None


def q21(d: Dataset, v: dict, dt: torch.dtype):
    s, o, li = d["supplier"], d["orders"], d["lineitem"]
    oi, of = lookup(o["o_orderkey"].data, li["l_orderkey"].data)
    sk = li["l_suppkey"].data
    late = li["l_receiptdate"].data > li["l_commitdate"].data
    n_ord = o["o_orderkey"].data.shape[0]

    def distinct_suppliers(rows: torch.Tensor) -> torch.Tensor:
        pairs = torch.unique(torch.stack([oi[rows], sk[rows]], 1), dim=0)
        return torch.bincount(pairs[:, 0], minlength=n_ord)

    all_supp = distinct_suppliers(of)
    late_supp = distinct_suppliers(of & late)
    si, sf = lookup(s["s_suppkey"].data, sk)
    m = of & sf & late & eq(o["o_orderstatus"], "F")[oi] \
        & (all_supp[oi] >= 2) & (late_supp[oi] == 1) \
        & member(s["s_nationkey"].data[si], _nation_key(d, v["NATION"]))
    inv, (srow,) = group(si[m])
    cnt = gcount(inv, len(srow))
    cols = [decode(s["s_name"], s["s_name"].data[srow]),
            host(cnt).astype(np.int64)]
    return finish(cols, [(1, "desc"), (0, "asc")], 100), \
        _agg(int(m.sum()), 0, len(srow))


def q22(d: Dataset, v: dict, dt: torch.dtype):
    c, o = d["customer"], d["orders"]
    phone = c["c_phone"]
    prefix = np.asarray(phone.dictionary.astype(str), dtype="U2")
    codes = np.array(sorted(set(v["CODE_LIST"])), dtype=object)
    code_of = np.searchsorted(codes.astype(str), prefix)
    known = (code_of < len(codes)) & (
        codes.astype(str)[np.minimum(code_of, len(codes) - 1)] == prefix)
    code_of = np.where(known, code_of, -1)
    cc = torch.as_tensor(code_of, device=phone.data.device)[
        phone.data.long()]
    bal = _f(c["c_acctbal"], dt)
    in_set = cc >= 0
    pos = in_set & (bal > _lit(0.0, dt, bal))
    avg = bal[pos].sum() / pos.sum().to(dt)
    ordered = member(c["c_custkey"].data, o["o_custkey"].data)
    m = in_set & (bal > avg) & ~ordered
    inv, (g,) = group(cc[m])
    cnt = gcount(inv, len(g))
    sums = gsum(bal[m], inv, len(g), dt)
    cols = [codes[host(g)], host(cnt).astype(np.int64), _out(sums)]
    return finish(cols, [(0, "asc")], None), _agg(int(m.sum()), 1, len(g))


QUERIES = {f"q{i:02d}": globals()[f"q{i:02d}"] for i in range(1, 23)}
