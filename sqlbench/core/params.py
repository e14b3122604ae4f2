"""Substitution parameters: one general generator over the rules that each
template's file states.

A template (``templates/<family>/<id>.toml``) holds its SQL text with
``{NAME}`` placeholders and a ``params`` table of rules, applied in the
order written.  Drawn kinds take values from the seed's stream; derived
kinds compute from earlier values:

- ``int``: ``lo`` to ``hi``, both included;
- ``choice``: one of ``values`` (a value may itself be a list);
- ``distinct``: ``count`` distinct values of ``values``, in drawn order;
- ``day`` / ``month`` / ``year``: a date from ``from`` to ``to`` (ISO; a
  month's or a year's first day), rendered ``YYYY-MM-DD``;
- ``const``: ``value``;
- ``shift``: the date ``of`` plus ``days`` (or the value of ``days_of``,
  times ``sign``), ``months`` and ``years``;
- ``add``: the number ``of`` plus ``by``;
- ``cents``: the number ``of`` plus ``by``, in hundredths, as ``0.05``;
- ``map``: ``table[str(of)]``;
- ``item``: element ``index`` of the list ``of``;
- ``join``: the list ``of`` joined by ``", "``, each value in quotes when
  ``quote`` is true;
- ``format``: ``template.format(**values)``;
- ``per_scale``: ``value`` divided by the configuration's scale factor.
"""
from __future__ import annotations

import datetime as _dt
import tomllib
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def load_template(family: str, tid: str) -> dict:
    """``templates/<family>/<tid>.toml``, with its id."""
    path = ROOT / "templates" / family / f"{tid}.toml"
    with open(path, "rb") as f:
        t = tomllib.load(f)
    t["id"] = tid
    return t


def _date(iso: str) -> _dt.date:
    return _dt.date.fromisoformat(iso)


def _add_months(d: _dt.date, months: int) -> _dt.date:
    m = d.month - 1 + months
    return _dt.date(d.year + m // 12, m % 12 + 1, d.day)


def _draw_rule(rule: dict, values: dict, rng: np.random.Generator,
               scale: float):
    kind = rule["kind"]
    if kind == "int":
        return int(rng.integers(rule["lo"], rule["hi"] + 1))
    if kind == "choice":
        return rule["values"][int(rng.integers(len(rule["values"])))]
    if kind == "distinct":
        idx = rng.permutation(len(rule["values"]))[:rule["count"]]
        return [rule["values"][int(i)] for i in idx]
    if kind == "day":
        lo, hi = _date(rule["from"]), _date(rule["to"])
        return (lo + _dt.timedelta(days=int(rng.integers(
            (hi - lo).days + 1)))).isoformat()
    if kind == "month":
        lo, hi = _date(rule["from"] + "-01"), _date(rule["to"] + "-01")
        span = (hi.year - lo.year) * 12 + hi.month - lo.month
        return _add_months(lo, int(rng.integers(span + 1))).isoformat()
    if kind == "year":
        return f"{int(rng.integers(rule['lo'], rule['hi'] + 1))}-01-01"
    if kind == "const":
        return rule["value"]
    if kind == "shift":
        d = _date(values[rule["of"]])
        n_days = rule.get("days", 0)
        if "days_of" in rule:
            n_days = values[rule["days_of"]]
        d = d + _dt.timedelta(days=rule.get("sign", 1) * n_days)
        d = _add_months(d, rule.get("months", 0) + 12 * rule.get("years", 0))
        return d.isoformat()
    if kind == "add":
        return values[rule["of"]] + rule["by"]
    if kind == "cents":
        return f"{(values[rule['of']] + rule.get('by', 0)) / 100:.2f}"
    if kind == "map":
        return rule["table"][str(values[rule["of"]])]
    if kind == "item":
        return values[rule["of"]][rule["index"]]
    if kind == "join":
        q = "'" if rule.get("quote") else ""
        return ", ".join(f"{q}{v}{q}" for v in values[rule["of"]])
    if kind == "format":
        return rule["template"].format(**values)
    if kind == "per_scale":
        return format(round(rule["value"] / scale, 12), ".12f").rstrip("0")
    raise ValueError(f"unknown parameter rule kind {kind!r}")


def draw(template: dict, rng: np.random.Generator, scale: float) -> dict:
    """One set of substitution values for ``template``."""
    values: dict = {}
    for name, rule in template.get("params", {}).items():
        values[name] = _draw_rule(rule, values, rng, scale)
    return values


def render(template: dict, values: dict) -> str:
    return template["sql"].format(**values).strip()


def draws(template: dict, seed: int, stream: int, n: int, scale: float,
          reserve: int = 0, tries: int = 64) -> List[dict]:
    """``n`` value sets for ``template`` from the seed: the first
    ``reserve`` for the warm-up, the rest for the window.  They are drawn
    without replacement while the domain lasts (a value set already drawn
    is drawn again, up to ``tries`` times), and the warm-up's are kept out
    of the window where the domain allows: a domain smaller than
    ``reserve`` + 1 leaves one set or more to the window, and the warm-up
    cycles over the others.  Once the window's sets are spent they repeat.
    Each set keeps its values and its SQL text."""
    rng = np.random.default_rng([int(seed) % (1 << 63), stream])
    out: List[dict] = []
    seen: Dict[str, int] = {}
    for _ in range(n):
        for _ in range(tries):
            values = draw(template, rng, scale)
            sql = render(template, values)
            if sql not in seen:
                break
        else:
            break
        seen[sql] = len(out)
        out.append({"values": values, "sql": sql})
    if not out:
        raise ValueError(f"template {template['id']} drew no value set")
    warm = min(reserve, len(out) - 1)
    window = out[warm:]
    head = [out[i % warm] for i in range(reserve)] if warm else \
        [out[0]] * reserve
    return head + [window[k % len(window)] for k in range(n - reserve)]
