"""TPC-H data on the device from a seed.

The distributions are a frozen copy of the repository's dbgen-shaped
generator (``benchmarks/tpch.py`` at the time the benchmark was written),
made with torch on the device instead of numpy on the host so that set-up
stays short at SF 10.  What it keeps from dbgen, and where it departs, is
listed under ``assumed`` in the configuration's file.  The random stream
is torch's, so a seed gives other values than the numpy generator, with
the same distributions.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.data import (Col, Dataset, blank, choice, days, digits, encode,
                         fixed, generator, round2, strings, unique_strings)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_SYL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
TYPES = [f"{a} {b} {c}" for a in TYPE_SYL1 for b in TYPE_SYL2
         for c in TYPE_SYL3]
CONT_SYL1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONT_SYL2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
CONTAINERS = [f"{a} {b}" for a in CONT_SYL1 for b in CONT_SYL2]
# dbgen's 92 colours (clause 4.2.3): p_name is five distinct ones
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki", "lace",
    "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya", "peach",
    "peru", "pink", "plum", "powder", "puff", "purple", "red", "rose",
    "rosy", "royal", "saddle", "salmon", "sandy", "seashell", "sienna",
    "sky", "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
    "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
# TPC-H's dates: orders from 1992-01-01 up to (not including) 1998-08-02;
# the return flag and line status turn at 1995-06-17
ORDER_DATE_LO, ORDER_DATE_HI = days("1992-01-01"), days("1998-08-02")
CURRENT_DATE = days("1995-06-17")


def sizes(sf: float) -> dict:
    return {"part": max(int(200_000 * sf), 50),
            "supplier": max(int(10_000 * sf), 10),
            "customer": max(int(150_000 * sf), 30),
            "orders": max(int(1_500_000 * sf), 150)}


def generate(config: dict, seed: int, device: torch.device) -> Dataset:
    """The eight tables of TPC-H at ``config["scale"]``."""
    sf = float(config["scale"])
    n = sizes(sf)
    n_part, n_supp, n_cust, n_ord = (n["part"], n["supplier"],
                                     n["customer"], n["orders"])
    i64 = dict(dtype=torch.int64, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    n_nation = len(NATIONS)

    region = {"r_regionkey": fixed(range(5), "int", device),
              "r_name": fixed(REGIONS, "str", device),
              "r_comment": fixed([""] * 5, "str", device)}
    nation = {"n_nationkey": fixed(range(n_nation), "int", device),
              "n_name": fixed([a for a, _ in NATIONS], "str", device),
              "n_regionkey": fixed([r for _, r in NATIONS], "int", device),
              "n_comment": fixed([""] * n_nation, "str", device)}

    g = generator(device, seed, 1)
    sk = np.arange(1, n_supp + 1)
    supplier = {
        "s_suppkey": Col("int", torch.arange(1, n_supp + 1, **i64)),
        "s_name": unique_strings(strings("Supplier#", digits(sk, 9)), device),
        "s_address": unique_strings(strings("addr", digits(sk - 1, 0)),
                                    device),
        "s_nationkey": Col("int", torch.randint(0, n_nation, (n_supp,),
                                                generator=g, **i64)),
        "s_phone": unique_strings(strings(digits(sk - 1, 10)), device),
        "s_acctbal": Col("float", round2(
            torch.rand(n_supp, generator=g, **f64) * (9999.99 + 999.99)
            - 999.99)),
        "s_comment": blank(n_supp, device),
    }

    g = generator(device, seed, 2)
    pk = torch.arange(1, n_part + 1, **i64)
    i = pk - 1
    brand_no = (i % 5 + 1) * 10 + (i // 5) % 5 + 1       # Brand#MN, M,N 1..5
    brands = [f"Brand#{m}{k}" for m in range(1, 6) for k in range(1, 6)]
    mfgrs = [f"Manufacturer#{m}" for m in range(1, 6)]
    words = torch.rand(n_part, len(COLORS), generator=g, device=device,
                       dtype=torch.float32).argsort(dim=1)[:, :5]
    names = np.asarray(COLORS, dtype=object)[words.cpu().numpy()]
    # clause 4.2.3: P_RETAILPRICE = (90000 + ((P_PARTKEY/10) modulo 20001)
    # + 100 * (P_PARTKEY modulo 1000)) / 100, here in cents
    retail_cents = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000)
    part = {
        "p_partkey": Col("int", pk),
        "p_name": encode([" ".join(r) for r in names.tolist()], device),
        "p_mfgr": choice(g, mfgrs, n_part, device, index=i % 5),
        "p_brand": choice(g, brands, n_part, device,
                          index=(brand_no // 10 - 1) * 5 + brand_no % 10 - 1),
        "p_type": choice(g, TYPES, n_part, device),
        "p_size": Col("int", torch.randint(1, 51, (n_part,), generator=g,
                                           **i64)),
        "p_container": choice(g, CONTAINERS, n_part, device),
        "p_retailprice": Col("float", retail_cents.to(torch.float64) / 100.0),
        "p_comment": blank(n_part, device),
    }

    # dbgen invariant: (ps_partkey, ps_suppkey) is a primary key -- each
    # part has 4 distinct suppliers by a strided formula, and lineitem
    # picks its supplier among the part's four
    step = max(n_supp // 4, 1)

    def psupp(partkey: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        return (partkey - 1 + k * step) % n_supp + 1

    g = generator(device, seed, 3)
    n_ps = n_part * 4
    ps_pk = pk.repeat_interleave(4)
    ps_k = torch.arange(4, **i64).repeat(n_part)
    partsupp = {
        "ps_partkey": Col("int", ps_pk),
        "ps_suppkey": Col("int", psupp(ps_pk, ps_k)),
        "ps_availqty": Col("int", torch.randint(1, 10_000, (n_ps,),
                                                generator=g, **i64)),
        "ps_supplycost": Col("float", round2(
            torch.rand(n_ps, generator=g, **f64) * 999.0 + 1.0)),
        "ps_comment": blank(n_ps, device),
    }

    g = generator(device, seed, 4)
    ck = np.arange(1, n_cust + 1)
    c_nationkey = torch.randint(0, n_nation, (n_cust,), generator=g, **i64)
    # dbgen's phones start with the country code nationkey + 10 (Q22)
    code = c_nationkey.cpu().numpy() + 10
    customer = {
        "c_custkey": Col("int", torch.arange(1, n_cust + 1, **i64)),
        "c_name": unique_strings(strings("Customer#", digits(ck, 9)), device),
        "c_address": unique_strings(strings("addr", digits(ck - 1, 0)),
                                    device),
        "c_nationkey": Col("int", c_nationkey),
        "c_phone": unique_strings(strings(digits(code, 2), "-",
                                          digits(ck - 1, 8)), device),
        "c_acctbal": Col("float", round2(
            torch.rand(n_cust, generator=g, **f64) * (9999.99 + 999.99)
            - 999.99)),
        "c_mktsegment": choice(g, SEGMENTS, n_cust, device),
        "c_comment": blank(n_cust, device),
    }

    g = generator(device, seed, 5)
    o_dates = torch.randint(ORDER_DATE_LO, ORDER_DATE_HI, (n_ord,),
                            generator=g, **i64)
    # dbgen: customers whose key is a multiple of 3 place no orders (Q22)
    o_custkey = torch.randint(1, n_cust + 1, (n_ord,), generator=g, **i64)
    o_custkey = o_custkey + (o_custkey % 3 == 0).to(torch.int64)
    o_custkey = torch.where(o_custkey > n_cust, torch.ones_like(o_custkey),
                            o_custkey)
    okeys = torch.arange(1, n_ord + 1, **i64) * 4          # sparse keys
    clerks = [f"Clerk#{k:09d}" for k in range(1000)]
    orders = {
        "o_orderkey": Col("int", okeys),
        "o_custkey": Col("int", o_custkey),
        "o_orderdate": Col("date", o_dates),
        "o_orderpriority": choice(g, PRIORITIES, n_ord, device),
        "o_clerk": choice(g, clerks, n_ord, device,
                          index=torch.arange(n_ord, **i64) % 1000),
        "o_shippriority": Col("int", torch.zeros(n_ord, **i64)),
        "o_comment": blank(n_ord, device),
    }

    g = generator(device, seed, 6)
    lines = torch.randint(1, 8, (n_ord,), generator=g, **i64)
    n_li = int(lines.sum())
    odate = o_dates.repeat_interleave(lines, output_size=n_li)
    first = (torch.cumsum(lines, 0) - lines).repeat_interleave(
        lines, output_size=n_li)
    ship = odate + torch.randint(1, 122, (n_li,), generator=g, **i64)
    commit = odate + torch.randint(30, 91, (n_li,), generator=g, **i64)
    receipt = ship + torch.randint(1, 31, (n_li,), generator=g, **i64)
    l_partkey = torch.randint(1, n_part + 1, (n_li,), generator=g, **i64)
    quantity = torch.randint(1, 51, (n_li,), generator=g, **i64)
    discount = torch.randint(0, 11, (n_li,), generator=g, **i64)
    tax = torch.randint(0, 9, (n_li,), generator=g, **i64)
    # clause 4.2.3: L_EXTENDEDPRICE = L_QUANTITY * P_RETAILPRICE (cents)
    ext_cents = quantity * retail_cents[l_partkey - 1]
    ra = torch.randint(0, 2, (n_li,), generator=g, **i64)    # R or A
    flag_index = torch.where(receipt <= CURRENT_DATE, ra * 2,
                             torch.ones_like(ra))            # R A N
    lineitem = {
        "l_orderkey": Col("int", okeys.repeat_interleave(lines,
                                                         output_size=n_li)),
        "l_partkey": Col("int", l_partkey),
        "l_suppkey": Col("int", psupp(l_partkey, torch.randint(
            0, 4, (n_li,), generator=g, **i64))),
        "l_linenumber": Col("int", torch.arange(n_li, **i64) - first + 1),
        "l_quantity": Col("float", quantity.to(torch.float64)),
        "l_extendedprice": Col("float", ext_cents.to(torch.float64) / 100.0),
        "l_discount": Col("float", discount.to(torch.float64) / 100.0),
        "l_tax": Col("float", tax.to(torch.float64) / 100.0),
        "l_returnflag": choice(g, ["R", "N", "A"], n_li, device,
                               index=flag_index),
        "l_linestatus": choice(g, ["F", "O"], n_li, device,
                               index=(ship > CURRENT_DATE).to(torch.int64)),
        "l_shipdate": Col("date", ship),
        "l_commitdate": Col("date", commit),
        "l_receiptdate": Col("date", receipt),
        "l_shipinstruct": choice(g, INSTRUCTS, n_li, device),
        "l_shipmode": choice(g, SHIPMODES, n_li, device),
        "l_comment": blank(n_li, device),
    }
    # clause 4.2.3: O_TOTALPRICE sums its lines' EXTENDEDPRICE * (1 + TAX)
    # * (1 - DISCOUNT), in cents as dbgen rounds them; O_ORDERSTATUS is F
    # where every line is F, O where every line is O, else P
    order_of = torch.arange(n_ord, **i64).repeat_interleave(
        lines, output_size=n_li)
    line_cents = ext_cents * (100 - discount) // 100 * (100 + tax) // 100
    total = torch.zeros(n_ord, **i64).index_add_(0, order_of, line_cents)
    open_lines = torch.zeros(n_ord, **i64).index_add_(
        0, order_of, (ship > CURRENT_DATE).to(torch.int64))
    status = torch.where(open_lines == 0, 0,
                         torch.where(open_lines == lines, 1, 2))
    orders = {"o_orderkey": orders.pop("o_orderkey"),
              "o_custkey": orders.pop("o_custkey"),
              "o_orderstatus": choice(g, ["F", "O", "P"], n_ord, device,
                                      index=status),
              "o_totalprice": Col("float", total.to(torch.float64) / 100.0),
              **orders}
    return {"region": region, "nation": nation, "supplier": supplier,
            "part": part, "partsupp": partsupp, "customer": customer,
            "orders": orders, "lineitem": lineitem}
