#include "plan.h"

#include <cmath>

namespace dsql {

// ---------------------------------------------------------------------------
// Rex constructors
// ---------------------------------------------------------------------------

RexP Rex::input_ref(int64_t idx, const SqlType& t) {
  auto r = std::make_shared<Rex>();
  r->kind = INPUT;
  r->index = idx;
  r->stype = t;
  return r;
}

RexP Rex::literal_bool(bool v, const SqlType& t) {
  auto r = std::make_shared<Rex>();
  r->kind = LIT;
  r->lkind = L_BOOL;
  r->bval = v;
  r->stype = t;
  return r;
}

RexP Rex::literal_int(int64_t v, const SqlType& t) {
  auto r = std::make_shared<Rex>();
  r->kind = LIT;
  r->lkind = L_INT;
  r->ival = v;
  r->stype = t;
  return r;
}

RexP Rex::call(const std::string& op, std::vector<RexP> ops,
               const SqlType& t) {
  auto r = std::make_shared<Rex>();
  r->kind = CALL;
  r->op = op;
  r->operands = std::move(ops);
  r->stype = t;
  return r;
}

RexP Rex::call_info(const std::string& op, std::vector<RexP> ops,
                    const SqlType& t, const SqlType& info) {
  auto r = std::make_shared<Rex>();
  r->kind = CALL;
  r->op = op;
  r->operands = std::move(ops);
  r->stype = t;
  r->has_info = true;
  r->info = info;
  return r;
}

// structural equality mirroring Python dataclass == (stype and info
// participate; subquery rex compares by plan identity like Python's
// default object field equality would only succeed on the same object)
bool rex_equal(const RexP& a, const RexP& b) {
  if (a == b) return true;
  if (!a || !b) return false;
  if (a->kind != b->kind || !(a->stype == b->stype)) return false;
  switch (a->kind) {
    case Rex::INPUT:
      return a->index == b->index;
    case Rex::LIT:
      if (a->lkind != b->lkind) return false;
      switch (a->lkind) {
        case Rex::L_NULL: return true;
        case Rex::L_BOOL: return a->bval == b->bval;
        case Rex::L_INT: return a->ival == b->ival;
        case Rex::L_DBL: return a->dval == b->dval;
        case Rex::L_STR: return a->sval == b->sval;
      }
      return false;
    case Rex::CALL: {
      if (a->op != b->op || a->has_info != b->has_info) return false;
      if (a->has_info && !(a->info == b->info)) return false;
      if (a->operands.size() != b->operands.size()) return false;
      for (size_t i = 0; i < a->operands.size(); ++i)
        if (!rex_equal(a->operands[i], b->operands[i])) return false;
      return true;
    }
    case Rex::SUBQ:
      return a->plan == b->plan;
  }
  return false;
}

// ---------------------------------------------------------------------------
// Rel helpers
// ---------------------------------------------------------------------------

std::vector<RelP> Rel::inputs() const {
  switch (kind) {
    case SCAN:
    case VALUES:
      return {};
    case JOIN:
      return {left, right};
    case UNION:
    case INTERSECT:
    case EXCEPT:
      return set_inputs;
    default:
      return {input};
  }
}

RelP Rel::with_inputs(const std::vector<RelP>& ins) const {
  auto n = std::make_shared<Rel>(*this);
  switch (kind) {
    case SCAN:
    case VALUES:
      break;
    case JOIN:
      n->left = ins.at(0);
      n->right = ins.at(1);
      break;
    case UNION:
    case INTERSECT:
    case EXCEPT:
      n->set_inputs = ins;
      break;
    default:
      n->input = ins.at(0);
      break;
  }
  return n;
}

RelP make_project(RelP in, std::vector<RexP> exprs,
                  std::vector<Field> schema) {
  auto n = std::make_shared<Rel>();
  n->kind = Rel::PROJECT;
  n->input = std::move(in);
  n->exprs = std::move(exprs);
  n->schema = std::move(schema);
  return n;
}

RelP make_filter(RelP in, RexP cond, std::vector<Field> schema) {
  auto n = std::make_shared<Rel>();
  n->kind = Rel::FILTER;
  n->input = std::move(in);
  n->condition = std::move(cond);
  n->schema = std::move(schema);
  return n;
}

RelP make_join(RelP l, RelP r, const std::string& jt, RexP cond,
               std::vector<Field> schema, bool null_aware) {
  auto n = std::make_shared<Rel>();
  n->kind = Rel::JOIN;
  n->left = std::move(l);
  n->right = std::move(r);
  n->join_type = jt;
  n->condition = std::move(cond);
  n->schema = std::move(schema);
  n->null_aware = null_aware;
  return n;
}

RelP make_aggregate(RelP in, std::vector<int64_t> gk,
                    std::vector<AggCall> aggs, std::vector<Field> schema) {
  auto n = std::make_shared<Rel>();
  n->kind = Rel::AGG;
  n->input = std::move(in);
  n->group_keys = std::move(gk);
  n->aggs = std::move(aggs);
  n->schema = std::move(schema);
  return n;
}

// ---------------------------------------------------------------------------
// rex utilities
// ---------------------------------------------------------------------------

void rex_inputs(const RexP& r, std::vector<int64_t>& out) {
  if (!r) return;
  if (r->kind == Rex::INPUT) {
    out.push_back(r->index);
  } else if (r->kind == Rex::CALL) {
    for (const auto& o : r->operands) rex_inputs(o, out);
  }
}

std::vector<int64_t> rex_inputs(const RexP& r) {
  std::vector<int64_t> out;
  rex_inputs(r, out);
  return out;
}

RexP remap_rex(const RexP& r, const std::map<int64_t, int64_t>& mapping) {
  if (r->kind == Rex::INPUT) {
    auto it = mapping.find(r->index);
    if (it == mapping.end()) throw PlanError("remap: unmapped ordinal");
    return Rex::input_ref(it->second, r->stype);
  }
  if (r->kind == Rex::CALL) {
    std::vector<RexP> ops;
    ops.reserve(r->operands.size());
    for (const auto& o : r->operands) ops.push_back(remap_rex(o, mapping));
    auto n = std::make_shared<Rex>(*r);
    n->operands = std::move(ops);
    return n;
  }
  return r;
}

// ---------------------------------------------------------------------------
// wire conversion
// ---------------------------------------------------------------------------

SqlType type_from_json(const JVP& v) {
  if (!v || v->kind != JV::ARR || v->arr.size() != 4)
    throw PlanError("bad SqlType");
  SqlType t;
  t.name = v->arr[0]->as_str();
  if (!v->arr[1]->is_null()) {
    t.has_prec = true;
    t.prec = v->arr[1]->as_int();
  }
  if (!v->arr[2]->is_null()) {
    t.has_scale = true;
    t.scale = v->arr[2]->as_int();
  }
  t.nullable = v->arr[3]->as_bool();
  return t;
}

JVP type_to_json(const SqlType& t) {
  auto a = JV::array();
  a->push(JV::str(t.name));
  a->push(t.has_prec ? JV::integer(t.prec) : JV::null());
  a->push(t.has_scale ? JV::integer(t.scale) : JV::null());
  a->push(JV::boolean(t.nullable));
  return a;
}

static Field field_from_json(const JVP& v) {
  if (!v || v->kind != JV::ARR || v->arr.size() != 2)
    throw PlanError("bad Field");
  return Field{v->arr[0]->as_str(), type_from_json(v->arr[1])};
}

static JVP field_to_json(const Field& f) {
  auto a = JV::array();
  a->push(JV::str(f.name));
  a->push(type_to_json(f.stype));
  return a;
}

static std::vector<Field> schema_from_json(const JVP& v) {
  if (!v || v->kind != JV::ARR) throw PlanError("bad schema");
  std::vector<Field> out;
  out.reserve(v->arr.size());
  for (const auto& f : v->arr) out.push_back(field_from_json(f));
  return out;
}

static JVP schema_to_json(const std::vector<Field>& s) {
  auto a = JV::array();
  for (const auto& f : s) a->push(field_to_json(f));
  return a;
}

RexP rex_from_json(const JVP& v) {
  if (!v || v->kind != JV::ARR || v->arr.empty())
    throw PlanError("bad rex");
  const std::string& tag = v->arr[0]->as_str();
  auto r = std::make_shared<Rex>();
  if (tag == "in") {
    r->kind = Rex::INPUT;
    r->index = v->arr[1]->as_int();
    r->stype = type_from_json(v->arr[2]);
    return r;
  }
  if (tag == "lit") {
    r->kind = Rex::LIT;
    const std::string& lt = v->arr[1]->as_str();
    const JVP& val = v->arr[2];
    if (lt == "n") r->lkind = Rex::L_NULL;
    else if (lt == "b") { r->lkind = Rex::L_BOOL; r->bval = val->as_bool(); }
    else if (lt == "i") { r->lkind = Rex::L_INT; r->ival = val->as_int(); }
    else if (lt == "f") { r->lkind = Rex::L_DBL; r->dval = val->as_double(); }
    else if (lt == "s") { r->lkind = Rex::L_STR; r->sval = val->as_str(); }
    else throw PlanError("bad literal tag");
    r->stype = type_from_json(v->arr[3]);
    return r;
  }
  if (tag == "call") {
    r->kind = Rex::CALL;
    r->op = v->arr[1]->as_str();
    if (v->arr[2]->kind != JV::ARR) throw PlanError("bad call operands");
    for (const auto& o : v->arr[2]->arr) r->operands.push_back(rex_from_json(o));
    r->stype = type_from_json(v->arr[3]);
    if (!v->arr[4]->is_null()) {
      r->has_info = true;
      r->info = type_from_json(v->arr[4]);
    }
    return r;
  }
  if (tag == "subq") {
    r->kind = Rex::SUBQ;
    r->plan = rel_from_json(v->arr[1]);
    r->stype = type_from_json(v->arr[2]);
    return r;
  }
  throw PlanError("unknown rex tag: " + tag);
}

JVP rex_to_json(const RexP& r) {
  auto a = JV::array();
  switch (r->kind) {
    case Rex::INPUT:
      a->push(JV::str("in"));
      a->push(JV::integer(r->index));
      a->push(type_to_json(r->stype));
      break;
    case Rex::LIT: {
      a->push(JV::str("lit"));
      switch (r->lkind) {
        case Rex::L_NULL:
          a->push(JV::str("n"));
          a->push(JV::null());
          break;
        case Rex::L_BOOL:
          a->push(JV::str("b"));
          a->push(JV::boolean(r->bval));
          break;
        case Rex::L_INT:
          a->push(JV::str("i"));
          a->push(JV::integer(r->ival));
          break;
        case Rex::L_DBL:
          a->push(JV::str("f"));
          a->push(JV::dbl(r->dval));
          break;
        case Rex::L_STR:
          a->push(JV::str("s"));
          a->push(JV::str(r->sval));
          break;
      }
      a->push(type_to_json(r->stype));
      break;
    }
    case Rex::CALL: {
      a->push(JV::str("call"));
      a->push(JV::str(r->op));
      auto ops = JV::array();
      for (const auto& o : r->operands) ops->push(rex_to_json(o));
      a->push(ops);
      a->push(type_to_json(r->stype));
      a->push(r->has_info ? type_to_json(r->info) : JV::null());
      break;
    }
    case Rex::SUBQ:
      a->push(JV::str("subq"));
      a->push(rel_to_json(r->plan));
      a->push(type_to_json(r->stype));
      break;
  }
  return a;
}

static SortCollation coll_from_json(const JVP& v) {
  if (!v || v->kind != JV::ARR || v->arr.size() != 3)
    throw PlanError("bad collation");
  SortCollation c;
  c.index = v->arr[0]->as_int();
  c.ascending = v->arr[1]->as_bool();
  c.nulls_first = v->arr[2]->is_null() ? -1 : (v->arr[2]->as_bool() ? 1 : 0);
  return c;
}

static JVP coll_to_json(const SortCollation& c) {
  auto a = JV::array();
  a->push(JV::integer(c.index));
  a->push(JV::boolean(c.ascending));
  a->push(c.nulls_first < 0 ? JV::null() : JV::boolean(c.nulls_first == 1));
  return a;
}

static AggCall agg_from_json(const JVP& v) {
  if (!v || v->kind != JV::ARR || v->arr.size() != 6)
    throw PlanError("bad AggCall");
  AggCall a;
  a.op = v->arr[0]->as_str();
  for (const auto& x : v->arr[1]->arr) a.args.push_back(x->as_int());
  a.distinct = v->arr[2]->as_bool();
  a.stype = type_from_json(v->arr[3]);
  a.name = v->arr[4]->as_str();
  if (!v->arr[5]->is_null()) {
    a.has_filter = true;
    a.filter_arg = v->arr[5]->as_int();
  }
  return a;
}

static JVP agg_to_json(const AggCall& a) {
  auto v = JV::array();
  v->push(JV::str(a.op));
  auto args = JV::array();
  for (int64_t x : a.args) args->push(JV::integer(x));
  v->push(args);
  v->push(JV::boolean(a.distinct));
  v->push(type_to_json(a.stype));
  v->push(JV::str(a.name));
  v->push(a.has_filter ? JV::integer(a.filter_arg) : JV::null());
  return v;
}

static WindowCall wcall_from_json(const JVP& v) {
  if (!v || v->kind != JV::ARR || v->arr.size() != 7)
    throw PlanError("bad WindowCall");
  WindowCall w;
  w.op = v->arr[0]->as_str();
  for (const auto& x : v->arr[1]->arr) w.args.push_back(x->as_int());
  for (const auto& x : v->arr[2]->arr) w.partition.push_back(x->as_int());
  for (const auto& x : v->arr[3]->arr) w.order.push_back(coll_from_json(x));
  w.frame = v->arr[4];  // opaque
  w.stype = type_from_json(v->arr[5]);
  w.name = v->arr[6]->as_str();
  return w;
}

static JVP wcall_to_json(const WindowCall& w) {
  auto v = JV::array();
  v->push(JV::str(w.op));
  auto args = JV::array();
  for (int64_t x : w.args) args->push(JV::integer(x));
  v->push(args);
  auto part = JV::array();
  for (int64_t x : w.partition) part->push(JV::integer(x));
  v->push(part);
  auto ord = JV::array();
  for (const auto& c : w.order) ord->push(coll_to_json(c));
  v->push(ord);
  v->push(w.frame ? w.frame : JV::null());
  v->push(type_to_json(w.stype));
  v->push(JV::str(w.name));
  return v;
}

RelP rel_from_json(const JVP& v) {
  if (!v || v->kind != JV::OBJ) throw PlanError("bad rel");
  const std::string& k = v->at("k")->as_str();
  auto n = std::make_shared<Rel>();
  n->schema = schema_from_json(v->at("schema"));
  if (k == "scan") {
    n->kind = Rel::SCAN;
    n->schema_name = v->at("sn")->as_str();
    n->table_name = v->at("tn")->as_str();
  } else if (k == "proj") {
    n->kind = Rel::PROJECT;
    n->input = rel_from_json(v->at("in"));
    for (const auto& e : v->at("exprs")->arr)
      n->exprs.push_back(rex_from_json(e));
  } else if (k == "filt") {
    n->kind = Rel::FILTER;
    n->input = rel_from_json(v->at("in"));
    n->condition = rex_from_json(v->at("cond"));
  } else if (k == "agg") {
    n->kind = Rel::AGG;
    n->input = rel_from_json(v->at("in"));
    for (const auto& g : v->at("gk")->arr)
      n->group_keys.push_back(g->as_int());
    for (const auto& a : v->at("aggs")->arr)
      n->aggs.push_back(agg_from_json(a));
  } else if (k == "join") {
    n->kind = Rel::JOIN;
    n->left = rel_from_json(v->at("l"));
    n->right = rel_from_json(v->at("r"));
    n->join_type = v->at("jt")->as_str();
    if (!v->at("cond")->is_null())
      n->condition = rex_from_json(v->at("cond"));
    n->null_aware = v->at("na")->as_bool();
  } else if (k == "sort") {
    n->kind = Rel::SORT;
    n->input = rel_from_json(v->at("in"));
    for (const auto& c : v->at("coll")->arr)
      n->collation.push_back(coll_from_json(c));
    if (!v->at("limit")->is_null()) {
      n->has_limit = true;
      n->limit = v->at("limit")->as_int();
    }
    if (!v->at("offset")->is_null()) {
      n->has_offset = true;
      n->offset = v->at("offset")->as_int();
    }
  } else if (k == "union" || k == "intersect" || k == "except") {
    n->kind = k == "union" ? Rel::UNION
              : k == "intersect" ? Rel::INTERSECT : Rel::EXCEPT;
    for (const auto& i : v->at("ins")->arr)
      n->set_inputs.push_back(rel_from_json(i));
    n->all_flag = v->at("all")->as_bool();
  } else if (k == "values") {
    n->kind = Rel::VALUES;
    for (const auto& row : v->at("rows")->arr) {
      std::vector<RexP> r;
      for (const auto& e : row->arr) r.push_back(rex_from_json(e));
      n->rows.push_back(std::move(r));
    }
  } else if (k == "window") {
    n->kind = Rel::WINDOW;
    n->input = rel_from_json(v->at("in"));
    for (const auto& c : v->at("calls")->arr)
      n->calls.push_back(wcall_from_json(c));
  } else if (k == "sample") {
    n->kind = Rel::SAMPLE;
    n->input = rel_from_json(v->at("in"));
    n->method = v->at("method")->as_str();
    n->percentage = v->at("pct")->as_double();
    if (!v->at("seed")->is_null()) {
      n->has_seed = true;
      n->seed = v->at("seed")->as_int();
    }
  } else {
    throw PlanError("unknown rel kind: " + k);
  }
  return n;
}

JVP rel_to_json(const RelP& r) {
  auto o = JV::object();
  switch (r->kind) {
    case Rel::SCAN:
      o->set("k", JV::str("scan"));
      o->set("sn", JV::str(r->schema_name));
      o->set("tn", JV::str(r->table_name));
      break;
    case Rel::PROJECT: {
      o->set("k", JV::str("proj"));
      o->set("in", rel_to_json(r->input));
      auto e = JV::array();
      for (const auto& x : r->exprs) e->push(rex_to_json(x));
      o->set("exprs", e);
      break;
    }
    case Rel::FILTER:
      o->set("k", JV::str("filt"));
      o->set("in", rel_to_json(r->input));
      o->set("cond", rex_to_json(r->condition));
      break;
    case Rel::AGG: {
      o->set("k", JV::str("agg"));
      o->set("in", rel_to_json(r->input));
      auto g = JV::array();
      for (int64_t x : r->group_keys) g->push(JV::integer(x));
      o->set("gk", g);
      auto a = JV::array();
      for (const auto& x : r->aggs) a->push(agg_to_json(x));
      o->set("aggs", a);
      break;
    }
    case Rel::JOIN:
      o->set("k", JV::str("join"));
      o->set("l", rel_to_json(r->left));
      o->set("r", rel_to_json(r->right));
      o->set("jt", JV::str(r->join_type));
      o->set("cond", r->condition ? rex_to_json(r->condition) : JV::null());
      o->set("na", JV::boolean(r->null_aware));
      break;
    case Rel::SORT: {
      o->set("k", JV::str("sort"));
      o->set("in", rel_to_json(r->input));
      auto c = JV::array();
      for (const auto& x : r->collation) c->push(coll_to_json(x));
      o->set("coll", c);
      o->set("limit", r->has_limit ? JV::integer(r->limit) : JV::null());
      o->set("offset", r->has_offset ? JV::integer(r->offset) : JV::null());
      break;
    }
    case Rel::UNION:
    case Rel::INTERSECT:
    case Rel::EXCEPT: {
      o->set("k", JV::str(r->kind == Rel::UNION ? "union"
                          : r->kind == Rel::INTERSECT ? "intersect"
                                                      : "except"));
      auto ins = JV::array();
      for (const auto& i : r->set_inputs) ins->push(rel_to_json(i));
      o->set("ins", ins);
      o->set("all", JV::boolean(r->all_flag));
      break;
    }
    case Rel::VALUES: {
      o->set("k", JV::str("values"));
      auto rows = JV::array();
      for (const auto& row : r->rows) {
        auto jr = JV::array();
        for (const auto& e : row) jr->push(rex_to_json(e));
        rows->push(jr);
      }
      o->set("rows", rows);
      break;
    }
    case Rel::WINDOW: {
      o->set("k", JV::str("window"));
      o->set("in", rel_to_json(r->input));
      auto c = JV::array();
      for (const auto& x : r->calls) c->push(wcall_to_json(x));
      o->set("calls", c);
      break;
    }
    case Rel::SAMPLE:
      o->set("k", JV::str("sample"));
      o->set("in", rel_to_json(r->input));
      o->set("method", JV::str(r->method));
      o->set("pct", JV::dbl(r->percentage));
      o->set("seed", r->has_seed ? JV::integer(r->seed) : JV::null());
      break;
  }
  o->set("schema", schema_to_json(r->schema));
  return o;
}

}  // namespace dsql
