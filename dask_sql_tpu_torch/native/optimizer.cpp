// Native rule-based heuristic optimizer — the C++ port of
// dask_sql_tpu/plan/optimizer.py (which reproduces the load-bearing effects
// of the reference's 17-rule HepPlanner program,
// upstream planner/.../RelationalAlgebraGenerator.java:198-224).
//
// Every pass is a faithful, lockstep port of its Python namesake: the
// Python implementation stays as the fallback (plans carrying Python-only
// payloads — UDFs, UDAFs — never reach this library), and
// tests/unit/test_native_optimizer.py asserts explain() equality between
// the two on the full TPC-H + fixture corpus.
#include <algorithm>
#include <cstring>
#include <functional>
#include <map>
#include <set>
#include <string>
#include <vector>

#include "plan.h"

namespace dsql {

namespace {

const SqlType BOOLEAN{"BOOLEAN"};
const SqlType BIGINT{"BIGINT"};

// ---------------------------------------------------------------------------
// generic helpers (optimizer.py:32-60)
// ---------------------------------------------------------------------------

void split_conjuncts(const RexP& rex, std::vector<RexP>& out) {
  if (rex->kind == Rex::CALL && rex->op == "AND") {
    split_conjuncts(rex->operands[0], out);
    split_conjuncts(rex->operands[1], out);
    return;
  }
  out.push_back(rex);
}

std::vector<RexP> split_conjuncts(const RexP& rex) {
  std::vector<RexP> out;
  split_conjuncts(rex, out);
  return out;
}

RexP and_all(const std::vector<RexP>& rexes) {
  if (rexes.empty()) return nullptr;
  RexP out = rexes[0];
  for (size_t i = 1; i < rexes.size(); ++i)
    out = Rex::call("AND", {out, rexes[i]}, BOOLEAN);
  return out;
}

bool is_pure(const RexP& rex) {
  switch (rex->kind) {
    case Rex::INPUT:
    case Rex::LIT:
      return true;
    case Rex::SUBQ:
      return false;
    case Rex::CALL: {
      if (rex->op == "RAND" || rex->op == "RANDOM" ||
          rex->op == "RAND_INTEGER")
        return false;
      for (const auto& o : rex->operands)
        if (!is_pure(o)) return false;
      return true;
    }
  }
  return false;
}

std::map<int64_t, int64_t> identity_shift(const RexP& c, int64_t delta) {
  std::map<int64_t, int64_t> m;
  for (int64_t i : rex_inputs(c)) m[i] = i + delta;
  return m;
}

// ---------------------------------------------------------------------------
// pass: merge_filters (optimizer.py:67-76)
// ---------------------------------------------------------------------------

RelP merge_filters(const RelP& rel0) {
  RelP rel = rel0;
  auto ins = rel->inputs();
  if (!ins.empty()) {
    std::vector<RelP> ni;
    for (const auto& i : ins) ni.push_back(merge_filters(i));
    rel = rel->with_inputs(ni);
  }
  if (rel->kind == Rel::FILTER) {
    if (rel->condition->is_true_literal()) return rel->input;
    if (rel->input->kind == Rel::FILTER) {
      RexP cond = Rex::call(
          "AND", {rel->input->condition, rel->condition}, BOOLEAN);
      return make_filter(rel->input->input, cond, rel->schema);
    }
  }
  return rel;
}

// ---------------------------------------------------------------------------
// pass: merge_projects (optimizer.py:83-113)
// ---------------------------------------------------------------------------

RexP inline_rex(const RexP& rex, const std::vector<RexP>& exprs) {
  if (rex->kind == Rex::INPUT) return exprs.at(rex->index);
  if (rex->kind == Rex::CALL) {
    std::vector<RexP> ops;
    ops.reserve(rex->operands.size());
    for (const auto& o : rex->operands) ops.push_back(inline_rex(o, exprs));
    auto n = std::make_shared<Rex>(*rex);
    n->operands = std::move(ops);
    return n;
  }
  return rex;
}

int64_t rex_size(const RexP& rex) {
  if (rex->kind == Rex::CALL) {
    int64_t s = 1;
    for (const auto& o : rex->operands) s += rex_size(o);
    return s;
  }
  return 1;
}

RelP merge_projects(const RelP& rel0) {
  RelP rel = rel0;
  auto ins = rel->inputs();
  if (!ins.empty()) {
    std::vector<RelP> ni;
    for (const auto& i : ins) ni.push_back(merge_projects(i));
    rel = rel->with_inputs(ni);
  }
  if (rel->kind == Rel::PROJECT && rel->input->kind == Rel::PROJECT) {
    const RelP& inner = rel->input;
    bool pure = true;
    for (const auto& e : inner->exprs)
      if (!is_pure(e)) { pure = false; break; }
    if (pure) {
      std::vector<RexP> new_exprs;
      new_exprs.reserve(rel->exprs.size());
      for (const auto& e : rel->exprs)
        new_exprs.push_back(inline_rex(e, inner->exprs));
      int64_t ns = 0, rs = 0, is = 0;
      for (const auto& e : new_exprs) ns += rex_size(e);
      for (const auto& e : rel->exprs) rs += rex_size(e);
      for (const auto& e : inner->exprs) is += rex_size(e);
      if (ns <= 4 * (rs + is))
        return make_project(inner->input, std::move(new_exprs), rel->schema);
    }
  }
  return rel;
}

// ---------------------------------------------------------------------------
// pass: push_filters (optimizer.py:121-233)
// ---------------------------------------------------------------------------

RelP push_filters(const RelP& rel0) {
  RelP rel = rel0;
  auto ins = rel->inputs();
  if (!ins.empty()) {
    std::vector<RelP> ni;
    for (const auto& i : ins) ni.push_back(push_filters(i));
    rel = rel->with_inputs(ni);
  }
  if (rel->kind != Rel::FILTER) return rel;
  const RelP& child = rel->input;
  std::vector<RexP> conjuncts = split_conjuncts(rel->condition);

  // -- through Project: rewrite refs via inlining (only pure exprs)
  if (child->kind == Rel::PROJECT) {
    bool pure_child = true;
    for (const auto& e : child->exprs)
      if (!is_pure(e)) { pure_child = false; break; }
    if (pure_child) {
      std::vector<RexP> pushable, stay;
      for (const auto& c : conjuncts)
        (is_pure(c) ? pushable : stay).push_back(c);
      if (!pushable.empty()) {
        std::vector<RexP> inlined;
        for (const auto& c : pushable)
          inlined.push_back(inline_rex(c, child->exprs));
        RelP new_input = push_filters(make_filter(
            child->input, and_all(inlined), child->input->schema));
        RelP new_child =
            make_project(new_input, child->exprs, child->schema);
        if (!stay.empty())
          return make_filter(new_child, and_all(stay), rel->schema);
        return new_child;
      }
    }
  }

  // -- into Join sides
  if (child->kind == Rel::JOIN &&
      (child->join_type == "INNER" || child->join_type == "LEFT" ||
       child->join_type == "RIGHT" || child->join_type == "CROSS")) {
    int64_t nl = (int64_t)child->left->schema.size();
    const std::string& jt0 = child->join_type;
    std::vector<RexP> left_side, right_side, into_join, stay;
    for (const auto& c : conjuncts) {
      auto refs = rex_inputs(c);
      bool all_left = true, all_right = true;
      for (int64_t r : refs) {
        if (r >= nl) all_left = false;
        if (r < nl) all_right = false;
      }
      if (!is_pure(c)) {
        stay.push_back(c);
      } else if (all_left &&
                 (jt0 == "INNER" || jt0 == "LEFT" || jt0 == "CROSS")) {
        left_side.push_back(c);
      } else if (all_right &&
                 (jt0 == "INNER" || jt0 == "RIGHT" || jt0 == "CROSS")) {
        right_side.push_back(c);
      } else if (jt0 == "INNER" || jt0 == "CROSS") {
        into_join.push_back(c);
      } else {
        stay.push_back(c);
      }
    }
    if (!left_side.empty() || !right_side.empty() || !into_join.empty()) {
      RelP new_left = child->left, new_right = child->right;
      if (!left_side.empty())
        new_left = push_filters(make_filter(
            child->left, and_all(left_side), child->left->schema));
      if (!right_side.empty()) {
        std::vector<RexP> shifted;
        for (const auto& c : right_side)
          shifted.push_back(remap_rex(c, identity_shift(c, -nl)));
        new_right = push_filters(make_filter(
            child->right, and_all(shifted), child->right->schema));
      }
      RexP cond = child->condition;
      std::string jt = child->join_type;
      if (!into_join.empty()) {
        std::vector<RexP> pieces;
        if (cond && !cond->is_true_literal()) pieces.push_back(cond);
        for (const auto& c : into_join) pieces.push_back(c);
        cond = and_all(pieces);
        jt = "INNER";
      }
      RelP new_join = make_join(new_left, new_right, jt, cond,
                                child->schema, false);
      if (!stay.empty())
        return make_filter(new_join, and_all(stay), rel->schema);
      return new_join;
    }
  }

  // -- through SEMI/ANTI joins (output IS the left input)
  if (child->kind == Rel::JOIN &&
      (child->join_type == "SEMI" || child->join_type == "ANTI")) {
    std::vector<RexP> pushable, stay;
    for (const auto& c : conjuncts)
      (is_pure(c) ? pushable : stay).push_back(c);
    if (!pushable.empty()) {
      RelP new_left = push_filters(make_filter(
          child->left, and_all(pushable), child->left->schema));
      RelP new_join =
          make_join(new_left, child->right, child->join_type,
                    child->condition, child->schema, child->null_aware);
      if (!stay.empty())
        return make_filter(new_join, and_all(stay), rel->schema);
      return new_join;
    }
  }

  // -- through Aggregate: conjuncts that only touch group keys
  if (child->kind == Rel::AGG) {
    int64_t n_keys = (int64_t)child->group_keys.size();
    std::vector<RexP> pushable, stay;
    for (const auto& c : conjuncts) {
      auto refs = rex_inputs(c);
      bool only_keys = true;
      for (int64_t r : refs)
        if (r >= n_keys) { only_keys = false; break; }
      if (is_pure(c) && only_keys)
        pushable.push_back(c);
      else
        stay.push_back(c);
    }
    if (!pushable.empty()) {
      std::map<int64_t, int64_t> mapping;
      for (int64_t i = 0; i < n_keys; ++i) mapping[i] = child->group_keys[i];
      std::vector<RexP> remapped;
      for (const auto& c : pushable)
        remapped.push_back(remap_rex(c, mapping));
      RelP new_input = push_filters(make_filter(
          child->input, and_all(remapped), child->input->schema));
      RelP new_agg = make_aggregate(new_input, child->group_keys,
                                    child->aggs, child->schema);
      if (!stay.empty())
        return make_filter(new_agg, and_all(stay), rel->schema);
      return new_agg;
    }
  }

  return rel;
}

// ---------------------------------------------------------------------------
// pass: reorder_joins (optimizer.py:240-430)
// ---------------------------------------------------------------------------

struct ReorderResult {
  RelP rel;
  std::vector<RexP> leftover;
};

bool reorder_chain(const RelP& root, const std::vector<RexP>& filt_conjuncts,
                   ReorderResult& out) {
  if (root->join_type != "INNER" && root->join_type != "CROSS") return false;
  std::vector<std::pair<int64_t, RelP>> leaves;  // (global offset, leaf)
  std::vector<RexP> pool;                        // global-ordinal conjuncts

  std::function<int64_t(const RelP&, int64_t)> flat =
      [&](const RelP& j, int64_t base) -> int64_t {
    if (j->kind == Rel::JOIN &&
        (j->join_type == "INNER" || j->join_type == "CROSS")) {
      int64_t lw = flat(j->left, base);
      int64_t rw = flat(j->right, base + lw);
      if (j->condition && !j->condition->is_true_literal()) {
        for (const auto& cj : split_conjuncts(j->condition))
          pool.push_back(remap_rex(cj, identity_shift(cj, base)));
      }
      return lw + rw;
    }
    leaves.emplace_back(base, j);
    return (int64_t)j->schema.size();
  };

  int64_t total = flat(root, 0);
  if (leaves.size() < 3) return false;

  std::map<int64_t, int64_t> leaf_of;
  for (size_t li = 0; li < leaves.size(); ++li) {
    int64_t off = leaves[li].first;
    for (int64_t o = off; o < off + (int64_t)leaves[li].second->schema.size();
         ++o)
      leaf_of[o] = (int64_t)li;
  }

  auto leafset = [&](const RexP& c) {
    std::set<int64_t> s;
    for (int64_t r : rex_inputs(c)) s.insert(leaf_of.at(r));
    return s;
  };
  auto is_equi = [](const RexP& c) {
    return c->kind == Rex::CALL && c->op == "=";
  };

  std::vector<RexP> cand = pool;
  for (const auto& c : filt_conjuncts)
    if (is_pure(c)) cand.push_back(c);
  std::vector<std::pair<RexP, std::set<int64_t>>> connectors;
  for (const auto& c : cand) {
    auto ls = leafset(c);
    if (ls.size() >= 2) connectors.emplace_back(c, ls);
  }
  if (connectors.empty()) return false;

  auto is_subset = [](const std::set<int64_t>& a,
                      const std::set<int64_t>& b) {
    for (int64_t x : a)
      if (!b.count(x)) return false;
    return true;
  };

  auto count_stranded = [&](const std::vector<int64_t>& seq) {
    std::set<int64_t> joined{seq[0]};
    int64_t bad = 0;
    for (size_t k = 1; k < seq.size(); ++k) {
      int64_t li = seq[k];
      bool connected = false;
      for (const auto& [c, ls] : connectors) {
        (void)c;
        if (ls.count(li)) {
          std::set<int64_t> rest = ls;
          rest.erase(li);
          if (is_subset(rest, joined)) { connected = true; break; }
        }
      }
      if (!connected) ++bad;
      joined.insert(li);
    }
    return bad;
  };

  // stranded count of the ORIGINAL (possibly bushy) tree
  int64_t leaf_counter = 0;
  std::function<std::pair<std::set<int64_t>, int64_t>(const RelP&)>
      tree_stranded = [&](const RelP& j)
      -> std::pair<std::set<int64_t>, int64_t> {
    if (j->kind == Rel::JOIN &&
        (j->join_type == "INNER" || j->join_type == "CROSS")) {
      auto [lset, lbad] = tree_stranded(j->left);
      auto [rset, rbad] = tree_stranded(j->right);
      std::set<int64_t> here = lset;
      here.insert(rset.begin(), rset.end());
      bool connected = false;
      for (const auto& [c, ls] : connectors) {
        (void)c;
        bool hits_l = false, hits_r = false;
        for (int64_t x : ls) {
          if (lset.count(x)) hits_l = true;
          if (rset.count(x)) hits_r = true;
        }
        if (hits_l && hits_r && is_subset(ls, here)) {
          connected = true;
          break;
        }
      }
      return {here, lbad + rbad + (connected ? 0 : 1)};
    }
    return {{leaf_counter++}, 0};
  };

  int64_t orig_stranded = tree_stranded(root).second;
  if (orig_stranded == 0) return false;

  // greedy order: prefer an equi-connected leaf (FROM order), then any
  // connected leaf, then fall back to a genuine cross step
  std::vector<int64_t> order{0};
  std::set<int64_t> joined{0};
  std::vector<int64_t> remaining;
  for (size_t i = 1; i < leaves.size(); ++i) remaining.push_back((int64_t)i);
  while (!remaining.empty()) {
    int64_t pick = -1;
    for (int want_equi = 1; want_equi >= 0 && pick < 0; --want_equi) {
      for (int64_t li : remaining) {
        for (const auto& [c, ls] : connectors) {
          if (ls.count(li)) {
            std::set<int64_t> rest = ls;
            rest.erase(li);
            if (is_subset(rest, joined) && (is_equi(c) || !want_equi)) {
              pick = li;
              break;
            }
          }
        }
        if (pick >= 0) break;
      }
    }
    if (pick < 0) pick = remaining[0];
    order.push_back(pick);
    joined.insert(pick);
    remaining.erase(std::find(remaining.begin(), remaining.end(), pick));
  }

  if (count_stranded(order) >= orig_stranded) return false;

  // ordinal mapping old-global -> new-global
  std::map<int64_t, int64_t> old_to_new;
  int64_t new_off = 0;
  for (int64_t li : order) {
    int64_t off = leaves[li].first;
    int64_t w = (int64_t)leaves[li].second->schema.size();
    for (int64_t k = 0; k < w; ++k) old_to_new[off + k] = new_off + k;
    new_off += w;
  }

  // left-deep tree, attaching each connector at the first step where all
  // its leaves are available
  std::vector<bool> placed(connectors.size(), false);
  std::vector<RexP> single;
  for (const auto& c : pool)
    if (leafset(c).size() < 2) single.push_back(c);
  RelP acc = leaves[order[0]].second;
  std::set<int64_t> covered{order[0]};
  for (size_t k = 1; k < order.size(); ++k) {
    int64_t li = order[k];
    covered.insert(li);
    std::vector<RexP> conds;
    for (size_t ci = 0; ci < connectors.size(); ++ci) {
      if (!placed[ci] && is_subset(connectors[ci].second, covered)) {
        placed[ci] = true;
        const RexP& c = connectors[ci].first;
        std::map<int64_t, int64_t> m;
        for (int64_t o : rex_inputs(c)) m[o] = old_to_new.at(o);
        conds.push_back(remap_rex(c, m));
      }
    }
    const RelP& leaf = leaves[li].second;
    std::vector<Field> schema = acc->schema;
    schema.insert(schema.end(), leaf->schema.begin(), leaf->schema.end());
    acc = make_join(acc, leaf, conds.empty() ? "CROSS" : "INNER",
                    and_all(conds), schema, false);
  }

  // restore the original column order for the parent
  std::vector<Field> orig_fields;
  for (const auto& [off, leaf] : leaves) {
    (void)off;
    orig_fields.insert(orig_fields.end(), leaf->schema.begin(),
                       leaf->schema.end());
  }
  std::vector<RexP> exprs;
  for (int64_t o = 0; o < total; ++o)
    exprs.push_back(Rex::input_ref(old_to_new.at(o), orig_fields[o].stype));
  RelP proj = make_project(acc, std::move(exprs), orig_fields);

  // leftovers: placed filter connectors disappear; single-leaf
  // join-condition conjuncts rejoin the filter pool
  std::set<const Rex*> used_filter;
  for (size_t ci = 0; ci < connectors.size(); ++ci) {
    if (!placed[ci]) continue;
    for (const auto& fc : filt_conjuncts)
      if (connectors[ci].first.get() == fc.get())
        used_filter.insert(fc.get());
  }
  std::vector<RexP> leftover;
  for (const auto& c : filt_conjuncts)
    if (!used_filter.count(c.get())) leftover.push_back(c);
  leftover.insert(leftover.end(), single.begin(), single.end());
  out.rel = proj;
  out.leftover = std::move(leftover);
  return true;
}

RelP reorder_joins(const RelP& rel0) {
  RelP rel = rel0;
  ReorderResult rr;
  bool matched = false;
  if (rel->kind == Rel::FILTER && rel->input->kind == Rel::JOIN) {
    matched = reorder_chain(rel->input, split_conjuncts(rel->condition), rr);
  } else if (rel->kind == Rel::JOIN) {
    matched = reorder_chain(rel, {}, rr);
  }
  if (matched) {
    RelP nw = rr.rel;
    if (!rr.leftover.empty())
      nw = make_filter(nw, and_all(rr.leftover), nw->schema);
    std::vector<RelP> ni;
    for (const auto& i : nw->inputs()) ni.push_back(reorder_joins(i));
    return nw->with_inputs(ni);
  }
  auto ins = rel->inputs();
  if (!ins.empty()) {
    std::vector<RelP> ni;
    for (const auto& i : ins) ni.push_back(reorder_joins(i));
    rel = rel->with_inputs(ni);
  }
  return rel;
}

// ---------------------------------------------------------------------------
// pass: factor_or_predicates (optimizer.py:604-655)
// ---------------------------------------------------------------------------

RexP factor_or(const RexP& rex0) {
  if (rex0->kind != Rex::CALL) return rex0;
  std::vector<RexP> ops;
  for (const auto& o : rex0->operands) ops.push_back(factor_or(o));
  auto rex = std::make_shared<Rex>(*rex0);
  rex->operands = std::move(ops);
  if (rex->op != "OR") return rex;

  std::function<void(const RexP&, std::vector<RexP>&)> branches =
      [&](const RexP& r, std::vector<RexP>& out) {
        if (r->kind == Rex::CALL && r->op == "OR") {
          branches(r->operands[0], out);
          branches(r->operands[1], out);
          return;
        }
        out.push_back(r);
      };
  std::vector<RexP> brs_flat;
  branches(rex, brs_flat);
  std::vector<std::vector<RexP>> brs;
  for (const auto& b : brs_flat) brs.push_back(split_conjuncts(b));

  std::vector<RexP> common;
  for (const auto& c : brs[0]) {
    if (!is_pure(c)) continue;
    bool in_all = true;
    for (size_t bi = 1; bi < brs.size(); ++bi) {
      bool found = false;
      for (const auto& d : brs[bi])
        if (rex_equal(c, d)) { found = true; break; }
      if (!found) { in_all = false; break; }
    }
    if (in_all) common.push_back(c);
  }
  if (common.empty()) return rex;

  std::vector<RexP> rest_branches;
  for (const auto& b : brs) {
    std::vector<RexP> rest;
    for (const auto& c : b) {
      bool is_common = false;
      for (const auto& d : common)
        if (rex_equal(c, d)) { is_common = true; break; }
      if (!is_common) rest.push_back(c);
    }
    RexP anded = and_all(rest);
    rest_branches.push_back(anded ? anded
                                  : Rex::literal_bool(true, BOOLEAN));
  }
  RexP rest_or = rest_branches[0];
  for (size_t k = 1; k < rest_branches.size(); ++k)
    rest_or = Rex::call("OR", {rest_or, rest_branches[k]}, BOOLEAN);
  std::vector<RexP> all = common;
  all.push_back(rest_or);
  return and_all(all);
}

RelP factor_or_predicates(const RelP& rel0) {
  RelP rel = rel0;
  auto ins = rel->inputs();
  if (!ins.empty()) {
    std::vector<RelP> ni;
    for (const auto& i : ins) ni.push_back(factor_or_predicates(i));
    rel = rel->with_inputs(ni);
  }
  if (rel->kind == Rel::FILTER)
    return make_filter(rel->input, factor_or(rel->condition), rel->schema);
  if (rel->kind == Rel::JOIN && rel->condition)
    return make_join(rel->left, rel->right, rel->join_type,
                     factor_or(rel->condition), rel->schema,
                     rel->null_aware);
  return rel;
}

// ---------------------------------------------------------------------------
// pass: push_join_side_conditions (optimizer.py:665-713)
// ---------------------------------------------------------------------------

RelP push_join_side_conditions(const RelP& rel0) {
  RelP rel = rel0;
  auto ins = rel->inputs();
  if (!ins.empty()) {
    std::vector<RelP> ni;
    for (const auto& i : ins) ni.push_back(push_join_side_conditions(i));
    rel = rel->with_inputs(ni);
  }
  if (!(rel->kind == Rel::JOIN &&
        (rel->join_type == "INNER" || rel->join_type == "LEFT" ||
         rel->join_type == "RIGHT") &&
        rel->condition))
    return rel;
  int64_t nl = (int64_t)rel->left->schema.size();
  bool left_ok = rel->join_type == "INNER" || rel->join_type == "RIGHT";
  bool right_ok = rel->join_type == "INNER" || rel->join_type == "LEFT";
  std::vector<RexP> stay, to_left, to_right;
  for (const auto& cj : split_conjuncts(rel->condition)) {
    auto refs = rex_inputs(cj);
    bool all_left = true, all_right = true;
    for (int64_t r : refs) {
      if (r >= nl) all_left = false;
      if (r < nl) all_right = false;
    }
    if (!is_pure(cj) || refs.empty())
      stay.push_back(cj);
    else if (all_left && left_ok)
      to_left.push_back(cj);
    else if (all_right && right_ok)
      to_right.push_back(cj);
    else
      stay.push_back(cj);
  }
  if (to_left.empty() && to_right.empty()) return rel;
  RelP new_left = rel->left, new_right = rel->right;
  if (!to_left.empty())
    new_left = make_filter(rel->left, and_all(to_left), rel->left->schema);
  if (!to_right.empty()) {
    std::vector<RexP> shifted;
    for (const auto& cj : to_right)
      shifted.push_back(remap_rex(cj, identity_shift(cj, -nl)));
    new_right =
        make_filter(rel->right, and_all(shifted), rel->right->schema);
  }
  RexP cond = stay.empty() ? nullptr : and_all(stay);
  return make_join(new_left, new_right, rel->join_type, cond, rel->schema,
                   rel->null_aware);
}

// ---------------------------------------------------------------------------
// split_join_condition (optimizer.py:716-745)
// ---------------------------------------------------------------------------

void split_join_condition(const RelP& rel, std::vector<std::pair<int64_t, int64_t>>& equi,
                          std::vector<RexP>& residual) {
  int64_t nl = (int64_t)rel->left->schema.size();
  std::function<void(const RexP&)> visit = [&](const RexP& rex) {
    if (rex->kind == Rex::CALL && rex->op == "AND") {
      visit(rex->operands[0]);
      visit(rex->operands[1]);
      return;
    }
    if (rex->kind == Rex::CALL && rex->op == "=" &&
        rex->operands.size() == 2) {
      const RexP& a = rex->operands[0];
      const RexP& b = rex->operands[1];
      if (a->kind == Rex::INPUT && b->kind == Rex::INPUT) {
        if (a->index < nl && nl <= b->index) {
          equi.emplace_back(a->index, b->index - nl);
          return;
        }
        if (b->index < nl && nl <= a->index) {
          equi.emplace_back(b->index, a->index - nl);
          return;
        }
      }
    }
    if (rex->is_true_literal()) return;
    residual.push_back(rex);
  };
  if (rel->condition) visit(rel->condition);
}

// ---------------------------------------------------------------------------
// pass: rewrite_exist_test_joins (optimizer.py:752-852)
// ---------------------------------------------------------------------------

bool is_exist_test_op(const std::string& op) {
  return op == "<>" || op == "<" || op == "<=" || op == ">" || op == ">=";
}

std::string exist_flip(const std::string& op) {
  if (op == "<") return ">";
  if (op == "<=") return ">=";
  if (op == ">") return "<";
  if (op == ">=") return "<=";
  return "<>";
}

RelP rewrite_exist_test_joins(const RelP& rel0) {
  RelP rel = rel0;
  auto ins = rel->inputs();
  if (!ins.empty()) {
    std::vector<RelP> ni;
    bool changed = false;
    for (const auto& i : ins) {
      RelP n = rewrite_exist_test_joins(i);
      if (n != i) changed = true;
      ni.push_back(n);
    }
    if (changed) rel = rel->with_inputs(ni);
  }
  if (rel->kind != Rel::JOIN ||
      (rel->join_type != "SEMI" && rel->join_type != "ANTI") ||
      rel->null_aware || !rel->condition)
    return rel;
  std::vector<std::pair<int64_t, int64_t>> equi;
  std::vector<RexP> residual;
  split_join_condition(rel, equi, residual);
  if (equi.empty() || residual.size() != 1) return rel;
  const RexP& r = residual[0];
  int64_t nl = (int64_t)rel->left->schema.size();
  if (!(r->kind == Rex::CALL && is_exist_test_op(r->op) &&
        r->operands.size() == 2 &&
        r->operands[0]->kind == Rex::INPUT &&
        r->operands[1]->kind == Rex::INPUT))
    return rel;
  const RexP& a = r->operands[0];
  const RexP& b = r->operands[1];
  int64_t y_idx, x_idx;
  std::string op;
  if (a->index < nl && nl <= b->index) {
    y_idx = a->index;
    x_idx = b->index - nl;
    op = exist_flip(r->op);
  } else if (b->index < nl && nl <= a->index) {
    y_idx = b->index;
    x_idx = a->index - nl;
    op = r->op;
  } else {
    return rel;
  }

  const RelP& right = rel->right;
  const Field& x_f = right->schema[x_idx];
  const Field& y_f = rel->left->schema[y_idx];
  if (x_f.stype.is_floating() || y_f.stype.is_floating()) return rel;
  std::vector<int64_t> gks;
  for (const auto& [pi, bi] : equi) {
    (void)pi;
    if (std::find(gks.begin(), gks.end(), bi) == gks.end())
      gks.push_back(bi);
  }
  std::vector<Field> key_fields;
  for (int64_t bi : gks)
    key_fields.push_back(
        Field{right->schema[bi].name, right->schema[bi].stype});
  std::vector<AggCall> pre_aggs;
  {
    AggCall cnt{"COUNT", {x_idx}, false, BIGINT, "cnt$"};
    AggCall mn{"MIN", {x_idx}, false, x_f.stype, "mn$"};
    AggCall mx{"MAX", {x_idx}, false, x_f.stype, "mx$"};
    pre_aggs = {cnt, mn, mx};
  }
  std::vector<Field> agg_schema = key_fields;
  agg_schema.push_back(Field{"cnt$", BIGINT});
  agg_schema.push_back(Field{"mn$", x_f.stype});
  agg_schema.push_back(Field{"mx$", x_f.stype});
  RelP agg = make_aggregate(right, gks, pre_aggs, agg_schema);

  std::map<int64_t, int64_t> pos_of;
  for (size_t i = 0; i < gks.size(); ++i) pos_of[gks[i]] = (int64_t)i;
  RexP cond;
  for (const auto& [pi, bi] : equi) {
    RexP eq = Rex::call(
        "=",
        {Rex::input_ref(pi, rel->left->schema[pi].stype),
         Rex::input_ref(nl + pos_of.at(bi), right->schema[bi].stype)},
        BOOLEAN);
    cond = cond ? Rex::call("AND", {cond, eq}, BOOLEAN) : eq;
  }
  int64_t nk = (int64_t)gks.size();
  std::vector<Field> j_schema = rel->left->schema;
  j_schema.insert(j_schema.end(), agg->schema.begin(), agg->schema.end());
  RelP joined =
      make_join(rel->left, agg,
                rel->join_type == "SEMI" ? "INNER" : "LEFT", cond,
                j_schema, false);
  RexP y = Rex::input_ref(y_idx, y_f.stype);
  RexP cnt = Rex::input_ref(nl + nk, BIGINT);
  RexP mn = Rex::input_ref(nl + nk + 1, x_f.stype);
  RexP mx = Rex::input_ref(nl + nk + 2, x_f.stype);
  RexP pred;
  if (op == "<>") {
    pred = Rex::call("OR",
                     {Rex::call("<>", {mn, y}, BOOLEAN),
                      Rex::call("<>", {mx, y}, BOOLEAN)},
                     BOOLEAN);
  } else if (op == "<" || op == "<=") {
    pred = Rex::call(op, {mn, y}, BOOLEAN);
  } else {
    pred = Rex::call(op, {mx, y}, BOOLEAN);
  }
  RexP cnt_pos = Rex::call(
      ">=",
      {Rex::call("COALESCE", {cnt, Rex::literal_int(0, BIGINT)}, BIGINT),
       Rex::literal_int(1, BIGINT)},
      BOOLEAN);
  RexP exists_pred = Rex::call("AND", {cnt_pos, pred}, BOOLEAN);
  RexP keep;
  if (rel->join_type == "SEMI") {
    keep = exists_pred;
  } else {
    keep = Rex::call("OR",
                     {Rex::call("IS_NULL", {y}, BOOLEAN),
                      Rex::call("NOT", {exists_pred}, BOOLEAN)},
                     BOOLEAN);
  }
  RelP filt = make_filter(joined, keep, joined->schema);
  std::vector<RexP> exprs;
  for (size_t i = 0; i < rel->left->schema.size(); ++i)
    exprs.push_back(
        Rex::input_ref((int64_t)i, rel->left->schema[i].stype));
  return make_project(filt, std::move(exprs), rel->schema);
}

// ---------------------------------------------------------------------------
// pass: aggregate_through_join (optimizer.py:858-952)
// ---------------------------------------------------------------------------

bool agg_through_join_op(const std::string& op) {
  return op == "COUNT" || op == "SUM" || op == "$SUM0" || op == "MIN" ||
         op == "MAX";
}

RelP aggregate_through_join(const RelP& rel0) {
  RelP rel = rel0;
  auto ins = rel->inputs();
  if (!ins.empty()) {
    std::vector<RelP> ni;
    for (const auto& i : ins) ni.push_back(aggregate_through_join(i));
    rel = rel->with_inputs(ni);
  }
  if (rel->kind != Rel::AGG) return rel;
  RelP join = rel->input;
  // look through a bare-ref projection (the binder's pre-projection)
  bool has_remap = false;
  std::vector<int64_t> remap;
  if (join->kind == Rel::PROJECT) {
    bool all_refs = true;
    for (const auto& e : join->exprs)
      if (e->kind != Rex::INPUT) { all_refs = false; break; }
    if (all_refs) {
      has_remap = true;
      for (const auto& e : join->exprs) remap.push_back(e->index);
      join = join->input;
    }
  }
  if (!(join->kind == Rel::JOIN &&
        (join->join_type == "INNER" || join->join_type == "LEFT") &&
        join->condition))
    return rel;

  auto m = [&](int64_t i) { return has_remap ? remap.at(i) : i; };

  std::vector<int64_t> group_keys;
  for (int64_t g : rel->group_keys) group_keys.push_back(m(g));
  std::vector<std::vector<int64_t>> agg_args;
  for (const auto& agg : rel->aggs) {
    std::vector<int64_t> args;
    for (int64_t a : agg.args) args.push_back(m(a));
    agg_args.push_back(std::move(args));
  }
  int64_t nl = (int64_t)join->left->schema.size();
  std::vector<int64_t> lkeys, rkeys;
  for (const auto& cj : split_conjuncts(join->condition)) {
    if (!(cj->kind == Rex::CALL && cj->op == "=" &&
          cj->operands.size() == 2 &&
          cj->operands[0]->kind == Rex::INPUT &&
          cj->operands[1]->kind == Rex::INPUT))
      return rel;
    int64_t a = cj->operands[0]->index, b = cj->operands[1]->index;
    if (a < nl && nl <= b) {
      lkeys.push_back(a);
      rkeys.push_back(b - nl);
    } else if (b < nl && nl <= a) {
      lkeys.push_back(b);
      rkeys.push_back(a - nl);
    } else {
      return rel;
    }
  }
  if (lkeys.empty()) return rel;
  for (int64_t g : group_keys)
    if (g >= nl) return rel;
  for (size_t i = 0; i < rel->aggs.size(); ++i) {
    const AggCall& agg = rel->aggs[i];
    const auto& args = agg_args[i];
    if (!agg_through_join_op(agg.op) || agg.distinct || agg.has_filter ||
        args.empty())
      return rel;
    for (int64_t a : args)
      if (a < nl) return rel;
  }

  // right pre-aggregate: group by the right join keys
  std::vector<Field> pre_fields;
  for (size_t i = 0; i < rkeys.size(); ++i)
    pre_fields.push_back(Field{"$jk" + std::to_string(i),
                               join->right->schema[rkeys[i]].stype});
  std::vector<AggCall> pre_aggs;
  for (size_t i = 0; i < rel->aggs.size(); ++i) {
    const AggCall& agg = rel->aggs[i];
    AggCall pa;
    pa.op = agg.op;
    for (int64_t a : agg_args[i]) pa.args.push_back(a - nl);
    pa.distinct = false;
    pa.stype = agg.stype;
    pa.name = "$pa" + std::to_string(i);
    pre_aggs.push_back(pa);
    pre_fields.push_back(Field{pa.name, agg.stype});
  }
  RelP pre = make_aggregate(join->right, rkeys, pre_aggs, pre_fields);

  RexP cond;
  for (size_t i = 0; i < lkeys.size(); ++i) {
    RexP eq = Rex::call(
        "=",
        {Rex::input_ref(lkeys[i], join->left->schema[lkeys[i]].stype),
         Rex::input_ref(nl + (int64_t)i, pre_fields[i].stype)},
        BOOLEAN);
    cond = cond ? Rex::call("AND", {cond, eq}, BOOLEAN) : eq;
  }
  std::vector<Field> j_schema = join->left->schema;
  j_schema.insert(j_schema.end(), pre_fields.begin(), pre_fields.end());
  RelP j2 = make_join(join->left, pre, join->join_type, cond, j_schema,
                      false);

  std::vector<AggCall> out_aggs;
  for (size_t i = 0; i < rel->aggs.size(); ++i) {
    const AggCall& agg = rel->aggs[i];
    AggCall oa;
    oa.op = agg.op == "COUNT" ? "$SUM0" : agg.op;
    oa.args = {nl + (int64_t)rkeys.size() + (int64_t)i};
    oa.distinct = false;
    oa.stype = agg.stype;
    oa.name = agg.name;
    out_aggs.push_back(oa);
  }
  return make_aggregate(j2, group_keys, out_aggs, rel->schema);
}

// ---------------------------------------------------------------------------
// pass: prune_columns (optimizer.py:442-597)
// ---------------------------------------------------------------------------

struct PruneResult {
  RelP rel;
  std::map<int64_t, int64_t> mapping;
};

PruneResult prune(const RelP& rel, const std::set<int64_t>& needed);

RelP prune_columns(const RelP& rel) {
  std::set<int64_t> all;
  for (size_t i = 0; i < rel->schema.size(); ++i) all.insert((int64_t)i);
  return prune(rel, all).rel;
}

std::map<int64_t, int64_t> identity_map(int64_t n) {
  std::map<int64_t, int64_t> m;
  for (int64_t i = 0; i < n; ++i) m[i] = i;
  return m;
}

PruneResult prune(const RelP& rel, const std::set<int64_t>& needed) {
  if (rel->kind == Rel::SCAN) {
    std::vector<int64_t> keep(needed.begin(), needed.end());
    if (keep.empty() && !rel->schema.empty()) keep = {0};
    std::vector<Field> new_schema;
    std::map<int64_t, int64_t> mapping;
    for (size_t i = 0; i < keep.size(); ++i) {
      new_schema.push_back(rel->schema[keep[i]]);
      mapping[keep[i]] = (int64_t)i;
    }
    auto n = std::make_shared<Rel>();
    n->kind = Rel::SCAN;
    n->schema_name = rel->schema_name;
    n->table_name = rel->table_name;
    n->schema = std::move(new_schema);
    return {n, mapping};
  }

  if (rel->kind == Rel::PROJECT) {
    std::vector<int64_t> keep(needed.begin(), needed.end());
    if (keep.empty() && !rel->exprs.empty()) keep = {0};
    std::set<int64_t> child_needed;
    for (int64_t i : keep)
      for (int64_t r : rex_inputs(rel->exprs[i])) child_needed.insert(r);
    PruneResult cr = prune(rel->input, child_needed);
    std::vector<RexP> new_exprs;
    std::vector<Field> new_schema;
    std::map<int64_t, int64_t> mapping;
    for (size_t i = 0; i < keep.size(); ++i) {
      new_exprs.push_back(remap_rex(rel->exprs[keep[i]], cr.mapping));
      new_schema.push_back(rel->schema[keep[i]]);
      mapping[keep[i]] = (int64_t)i;
    }
    return {make_project(cr.rel, std::move(new_exprs), std::move(new_schema)),
            mapping};
  }

  if (rel->kind == Rel::FILTER) {
    std::set<int64_t> child_needed = needed;
    for (int64_t r : rex_inputs(rel->condition)) child_needed.insert(r);
    PruneResult cr = prune(rel->input, child_needed);
    RexP cond = remap_rex(rel->condition, cr.mapping);
    std::vector<int64_t> keep;
    if (!needed.empty()) {
      keep.assign(needed.begin(), needed.end());
    } else {
      for (const auto& kv : cr.mapping) keep.push_back(kv.first);
    }
    std::vector<Field> new_schema;
    for (int64_t i : keep) new_schema.push_back(rel->schema[i]);
    std::vector<int64_t> cmap_keys;
    for (const auto& kv : cr.mapping) cmap_keys.push_back(kv.first);
    bool identity = cmap_keys == keep;
    if (identity) {
      for (size_t j = 0; j < keep.size(); ++j)
        if (cr.mapping.at(keep[j]) != (int64_t)j) { identity = false; break; }
    }
    std::map<int64_t, int64_t> out_map;
    for (size_t j = 0; j < keep.size(); ++j) out_map[keep[j]] = (int64_t)j;
    if (identity)
      return {make_filter(cr.rel, cond, new_schema), out_map};
    RelP filt = make_filter(cr.rel, cond, cr.rel->schema);
    std::vector<RexP> exprs;
    for (int64_t i : keep)
      exprs.push_back(
          Rex::input_ref(cr.mapping.at(i), rel->schema[i].stype));
    RelP proj = make_project(filt, std::move(exprs), new_schema);
    return {proj, out_map};
  }

  if (rel->kind == Rel::AGG) {
    int64_t n_keys = (int64_t)rel->group_keys.size();
    std::vector<int64_t> used_aggs;
    for (int64_t i : needed)
      if (i >= n_keys) used_aggs.push_back(i - n_keys);
    std::sort(used_aggs.begin(), used_aggs.end());
    std::set<int64_t> child_needed(rel->group_keys.begin(),
                                   rel->group_keys.end());
    for (int64_t ai : used_aggs) {
      for (int64_t a : rel->aggs[ai].args) child_needed.insert(a);
      if (rel->aggs[ai].has_filter)
        child_needed.insert(rel->aggs[ai].filter_arg);
    }
    PruneResult cr = prune(rel->input, child_needed);
    std::vector<int64_t> new_keys;
    for (int64_t k : rel->group_keys) new_keys.push_back(cr.mapping.at(k));
    std::vector<AggCall> new_aggs;
    for (int64_t ai : used_aggs) {
      const AggCall& a = rel->aggs[ai];
      AggCall na = a;
      na.args.clear();
      for (int64_t x : a.args) na.args.push_back(cr.mapping.at(x));
      if (a.has_filter) na.filter_arg = cr.mapping.at(a.filter_arg);
      new_aggs.push_back(na);
    }
    std::vector<Field> new_schema(rel->schema.begin(),
                                  rel->schema.begin() + n_keys);
    for (int64_t ai : used_aggs)
      new_schema.push_back(rel->schema[n_keys + ai]);
    std::map<int64_t, int64_t> mapping;
    for (int64_t i = 0; i < n_keys; ++i) mapping[i] = i;
    for (size_t j = 0; j < used_aggs.size(); ++j)
      mapping[n_keys + used_aggs[j]] = n_keys + (int64_t)j;
    return {make_aggregate(cr.rel, new_keys, new_aggs, new_schema), mapping};
  }

  if (rel->kind == Rel::JOIN) {
    int64_t nl = (int64_t)rel->left->schema.size();
    std::set<int64_t> all_needed = needed;
    if (rel->condition)
      for (int64_t r : rex_inputs(rel->condition)) all_needed.insert(r);
    std::set<int64_t> left_needed, right_needed;
    for (int64_t i : all_needed) {
      if (i < nl)
        left_needed.insert(i);
      else
        right_needed.insert(i - nl);
    }
    PruneResult lr = prune(rel->left, left_needed);
    PruneResult rr = prune(rel->right, right_needed);
    int64_t new_nl = (int64_t)lr.rel->schema.size();
    std::map<int64_t, int64_t> mapping;
    for (const auto& kv : lr.mapping) mapping[kv.first] = kv.second;
    for (const auto& kv : rr.mapping)
      mapping[nl + kv.first] = new_nl + kv.second;
    RexP cond =
        rel->condition ? remap_rex(rel->condition, mapping) : nullptr;
    std::vector<Field> new_schema;
    std::map<int64_t, int64_t> out_mapping;
    if (rel->join_type == "SEMI" || rel->join_type == "ANTI") {
      for (const auto& kv : lr.mapping)
        new_schema.push_back(rel->schema[kv.first]);
      out_mapping = lr.mapping;
    } else {
      for (const auto& kv : lr.mapping)
        new_schema.push_back(rel->schema[kv.first]);
      for (const auto& kv : rr.mapping)
        new_schema.push_back(rel->schema[nl + kv.first]);
      out_mapping = mapping;
    }
    RelP out = make_join(lr.rel, rr.rel, rel->join_type, cond, new_schema,
                         rel->null_aware);
    return {out, out_mapping};
  }

  if (rel->kind == Rel::SORT) {
    std::set<int64_t> child_needed = needed;
    for (const auto& c : rel->collation) child_needed.insert(c.index);
    PruneResult cr = prune(rel->input, child_needed);
    std::vector<SortCollation> coll;
    for (const auto& c : rel->collation) {
      SortCollation nc = c;
      nc.index = cr.mapping.at(c.index);
      coll.push_back(nc);
    }
    std::vector<Field> new_schema;
    for (const auto& kv : cr.mapping) new_schema.push_back(rel->schema[kv.first]);
    auto n = std::make_shared<Rel>(*rel);
    n->input = cr.rel;
    n->collation = std::move(coll);
    n->schema = std::move(new_schema);
    return {n, cr.mapping};
  }

  if (rel->kind == Rel::WINDOW) {
    int64_t n_in = (int64_t)rel->input->schema.size();
    std::vector<int64_t> used_calls;
    for (int64_t i : needed)
      if (i >= n_in) used_calls.push_back(i - n_in);
    std::sort(used_calls.begin(), used_calls.end());
    std::set<int64_t> child_needed;
    for (int64_t i : needed)
      if (i < n_in) child_needed.insert(i);
    for (int64_t ci : used_calls) {
      const WindowCall& c = rel->calls[ci];
      for (int64_t a : c.args) child_needed.insert(a);
      for (int64_t p : c.partition) child_needed.insert(p);
      for (const auto& k : c.order) child_needed.insert(k.index);
    }
    PruneResult cr = prune(rel->input, child_needed);
    std::vector<WindowCall> new_calls;
    for (int64_t ci : used_calls) {
      const WindowCall& c = rel->calls[ci];
      WindowCall nc = c;
      nc.args.clear();
      for (int64_t a : c.args) nc.args.push_back(cr.mapping.at(a));
      nc.partition.clear();
      for (int64_t p : c.partition) nc.partition.push_back(cr.mapping.at(p));
      nc.order.clear();
      for (const auto& k : c.order) {
        SortCollation nk = k;
        nk.index = cr.mapping.at(k.index);
        nc.order.push_back(nk);
      }
      new_calls.push_back(nc);
    }
    std::vector<Field> new_schema = cr.rel->schema;
    for (int64_t ci : used_calls)
      new_schema.push_back(rel->schema[n_in + ci]);
    std::map<int64_t, int64_t> mapping = cr.mapping;
    for (size_t j = 0; j < used_calls.size(); ++j)
      mapping[n_in + used_calls[j]] =
          (int64_t)cr.rel->schema.size() + (int64_t)j;
    auto n = std::make_shared<Rel>(*rel);
    n->input = cr.rel;
    n->calls = std::move(new_calls);
    n->schema = std::move(new_schema);
    return {n, mapping};
  }

  if (rel->kind == Rel::UNION || rel->kind == Rel::INTERSECT ||
      rel->kind == Rel::EXCEPT) {
    std::vector<RelP> new_inputs;
    for (const auto& i : rel->set_inputs) {
      std::set<int64_t> all;
      for (size_t k = 0; k < i->schema.size(); ++k) all.insert((int64_t)k);
      new_inputs.push_back(prune(i, all).rel);
    }
    RelP out = rel->with_inputs(new_inputs);
    return {out, identity_map((int64_t)rel->schema.size())};
  }

  if (rel->kind == Rel::SAMPLE) {
    PruneResult cr = prune(rel->input, needed);
    auto n = std::make_shared<Rel>(*rel);
    n->input = cr.rel;
    n->schema = cr.rel->schema;
    return {n, cr.mapping};
  }

  // default (VALUES): require everything below, identity above
  RelP out = rel;
  auto ins = rel->inputs();
  if (!ins.empty()) {
    std::vector<RelP> new_inputs;
    for (const auto& i : ins) {
      std::set<int64_t> all;
      for (size_t k = 0; k < i->schema.size(); ++k) all.insert((int64_t)k);
      new_inputs.push_back(prune(i, all).rel);
    }
    out = rel->with_inputs(new_inputs);
  }
  return {out, identity_map((int64_t)out->schema.size())};
}

// ---------------------------------------------------------------------------
// optimize_subplans + the top-level loop (optimizer.py:955-994)
// ---------------------------------------------------------------------------

RexP optimize_rex_subplans(const RexP& r) {
  if (r->kind == Rex::SUBQ) {
    auto n = std::make_shared<Rex>(*r);
    n->plan = optimize_plan(r->plan, true);
    return n;
  }
  if (r->kind == Rex::CALL) {
    std::vector<RexP> ops;
    bool changed = false;
    for (const auto& o : r->operands) {
      RexP n = optimize_rex_subplans(o);
      if (n != o) changed = true;
      ops.push_back(n);
    }
    if (!changed) return r;
    auto n = std::make_shared<Rex>(*r);
    n->operands = std::move(ops);
    return n;
  }
  return r;
}

RelP optimize_subplans(const RelP& rel0) {
  RelP rel = rel0;
  auto ins = rel->inputs();
  if (!ins.empty()) {
    std::vector<RelP> ni;
    for (const auto& i : ins) ni.push_back(optimize_subplans(i));
    rel = rel->with_inputs(ni);
  }
  if (rel->kind == Rel::PROJECT) {
    std::vector<RexP> exprs;
    bool changed = false;
    for (const auto& e : rel->exprs) {
      RexP n = optimize_rex_subplans(e);
      if (n != e) changed = true;
      exprs.push_back(n);
    }
    if (changed) return make_project(rel->input, std::move(exprs), rel->schema);
  } else if (rel->kind == Rel::FILTER) {
    RexP n = optimize_rex_subplans(rel->condition);
    if (n != rel->condition) return make_filter(rel->input, n, rel->schema);
  } else if (rel->kind == Rel::JOIN && rel->condition) {
    RexP n = optimize_rex_subplans(rel->condition);
    if (n != rel->condition)
      return make_join(rel->left, rel->right, rel->join_type, n,
                       rel->schema, rel->null_aware);
  }
  return rel;
}

}  // namespace

RelP optimize_plan(RelP plan, bool enable_pruning) {
  // PASSES (optimizer.py:955-959)
  plan = merge_filters(plan);
  plan = factor_or_predicates(plan);
  plan = push_filters(plan);
  plan = merge_filters(plan);
  plan = reorder_joins(plan);
  plan = push_filters(plan);
  plan = merge_filters(plan);
  plan = push_join_side_conditions(plan);
  plan = push_filters(plan);
  plan = merge_filters(plan);
  plan = rewrite_exist_test_joins(plan);
  plan = aggregate_through_join(plan);
  plan = merge_projects(plan);
  plan = optimize_subplans(plan);
  if (enable_pruning) {
    plan = prune_columns(plan);
    plan = merge_projects(plan);
  }
  return plan;
}

}  // namespace dsql
