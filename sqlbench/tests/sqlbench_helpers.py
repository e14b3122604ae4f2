"""Shared pieces of the benchmark's CPU tests: small data sets, the
validation literals of the repository's fixed TPC-H texts, and the two
independent oracles' inputs (pandas frames and an sqlite database)."""
from __future__ import annotations

import functools
import re
import sqlite3
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from sqlbench.core.data import Dataset  # noqa: E402
from sqlbench.gen import tpch  # noqa: E402

CPU = torch.device("cpu")
SF_TPCH = 0.01

# the literals of the repository's fixed TPC-H texts (the pandas oracle's)
VALIDATION = {
    "q01": {"CUTOFF": "1998-09-02"},
    "q02": {"SIZE": 15, "TYPE": "BRASS", "REGION": "EUROPE"},
    "q03": {"SEGMENT": "BUILDING", "DATE": "1995-03-15"},
    "q04": {"DATE": "1993-07-01", "END": "1993-10-01"},
    "q05": {"REGION": "ASIA", "DATE": "1994-01-01", "END": "1995-01-01"},
    "q06": {"DATE": "1994-01-01", "END": "1995-01-01", "DISC_LO": "0.05",
            "DISC_HI": "0.07", "QUANTITY": 24},
    "q07": {"NATION1": "FRANCE", "NATION2": "GERMANY"},
    "q08": {"NATION": "BRAZIL", "REGION": "AMERICA",
            "TYPE": "ECONOMY ANODIZED STEEL"},
    "q09": {"COLOR": "green"},
    "q10": {"DATE": "1993-10-01", "END": "1994-01-01"},
    "q11": {"NATION": "GERMANY", "FRACTION": "0.0001"},
    "q12": {"SHIPMODE1": "MAIL", "SHIPMODE2": "SHIP", "DATE": "1994-01-01",
            "END": "1995-01-01"},
    "q13": {"WORD1": "special", "WORD2": "requests"},
    "q14": {"DATE": "1995-09-01", "END": "1995-10-01"},
    "q15": {"DATE": "1996-01-01", "END": "1996-04-01"},
    "q16": {"BRAND": "Brand#45", "TYPE": "MEDIUM POLISHED",
            "SIZE_LIST": [49, 14, 23, 45, 19, 3, 36, 9]},
    "q17": {"BRAND": "Brand#23", "CONTAINER": "MED BOX"},
    "q18": {"QUANTITY": 300},
    "q19": {"QUANTITY1": 1, "QUANTITY1_HI": 11, "QUANTITY2": 10,
            "QUANTITY2_HI": 20, "QUANTITY3": 20, "QUANTITY3_HI": 30,
            "BRAND1": "Brand#12", "BRAND2": "Brand#23", "BRAND3": "Brand#34"},
    "q20": {"COLOR": "ivory", "DATE": "1994-01-01", "END": "1995-01-01",
            "NATION": "CANADA"},
    "q21": {"NATION": "SAUDI ARABIA"},
    "q22": {"CODE_LIST": ["13", "31", "23", "29", "30", "18", "17"]},
}


@functools.lru_cache(maxsize=None)
def tpch_data(seed: int = 7) -> Dataset:
    return tpch.generate({"scale": SF_TPCH}, seed, CPU)


def host_columns(table: dict) -> dict:
    """A table's columns decoded to host arrays: strings as str, dates as
    datetime64[D]."""
    out = {}
    for name, col in table.items():
        v = col.data.numpy()
        if col.kind == "str":
            out[name] = col.dictionary[v]
        elif col.kind == "date":
            out[name] = v.astype("datetime64[D]")
        else:
            out[name] = v
    return out


def pandas_tables(data: Dataset) -> dict:
    import pandas as pd

    out = {}
    for tname, table in data.items():
        cols = host_columns(table)
        out[tname] = pd.DataFrame({
            k: (v.astype("datetime64[ns]") if v.dtype.kind == "M" else v)
            for k, v in cols.items()})
    return out


def sqlite_db(data: Dataset) -> sqlite3.Connection:
    """An in-memory sqlite database of the data: dates as ISO strings, an
    index on every key column (it changes no answer)."""
    conn = sqlite3.connect(":memory:")
    for tname, table in data.items():
        cols = host_columns(table)
        decl, values = [], []
        for name, arr in cols.items():
            if arr.dtype.kind == "M":
                values.append(np.datetime_as_string(arr, unit="D").tolist())
                decl.append(f"{name} TEXT")
            else:
                values.append(arr.tolist())
                decl.append(f"{name} " + {"i": "INTEGER", "f": "REAL"}.get(
                    arr.dtype.kind, "TEXT"))
        conn.execute(f"CREATE TABLE {tname} ({', '.join(decl)})")
        conn.executemany(
            f"INSERT INTO {tname} VALUES ({', '.join('?' * len(cols))})",
            zip(*values))
        for name in cols:
            if name.endswith("key"):
                conn.execute(f"CREATE INDEX {name}_idx ON {tname} ({name})")
    return conn


def to_sqlite(sql: str) -> str:
    sql = sql.replace("DATE '", "'")
    sql = re.sub(r"SUBSTRING\(\s*(\w+)\s+FROM\s+(\d+)\s+FOR\s+(\d+)\s*\)",
                 r"substr(\1, \2, \3)", sql)
    return re.sub(r"EXTRACT\(\s*YEAR\s+FROM\s+(\w+)\s*\)",
                  r"CAST(strftime('%Y', \1) AS INTEGER)", sql)


def sqlite_answer(conn, sql: str, like_cols) -> list:
    """sqlite's rows as columns typed like the reference's columns."""
    rows = conn.execute(to_sqlite(sql)).fetchall()
    cols = list(zip(*rows)) if rows else [[] for _ in like_cols]
    out = []
    for vals, like in zip(cols, like_cols):
        kind = np.asarray(like).dtype.kind
        if kind == "M":
            out.append(np.array(vals, dtype="datetime64[D]"))
        elif kind == "f":
            out.append(np.array([np.nan if v is None else v for v in vals],
                                dtype=np.float64))
        elif kind in "iu":
            out.append(np.array(vals, dtype=np.int64))
        else:
            out.append(np.array(vals, dtype=object))
    return out


def frame_columns(frame) -> list:
    out = []
    for name in frame.columns:
        v = frame[name].to_numpy()
        if v.dtype.kind == "M":
            v = v.astype("datetime64[D]")
        elif v.dtype.kind == "O" or str(frame[name].dtype) in ("str",
                                                               "string"):
            v = np.asarray(frame[name].astype(object).to_numpy(), dtype=object)
        out.append(v)
    return out
