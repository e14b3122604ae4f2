// Bound logical plans for the native optimizer — the C++ mirror of
// dask_sql_tpu/plan/nodes.py (same node vocabulary, same field meanings).
// Nodes are immutable and shared (shared_ptr); every rewrite builds new
// nodes, mirroring the Python passes' with_inputs/dataclass style.
//
// Wire format (Python bridge: dask_sql_tpu/plan/native_planner.py):
//   SqlType  [name, prec|null, scale|null, nullable]
//   Field    [name, SqlType]
//   Rex      ["in", index, SqlType]
//            ["lit", tag, value, SqlType]     tag: "n" | "b" | "i" | "f" | "s"
//            ["call", op, [Rex...], SqlType, info(SqlType)|null]
//            ["subq", Rel, SqlType]
//   Rel      object with "k" discriminator — see from_json/to_json.
#pragma once

#include <cstdint>
#include <map>
#include <memory>
#include <string>
#include <vector>

#include "json.h"

namespace dsql {

struct PlanError : std::runtime_error {
  explicit PlanError(const std::string& m) : std::runtime_error(m) {}
};

struct SqlType {
  std::string name;
  bool has_prec = false;
  int64_t prec = 0;
  bool has_scale = false;
  int64_t scale = 0;
  bool nullable = true;

  bool operator==(const SqlType& o) const {
    return name == o.name && has_prec == o.has_prec && prec == o.prec &&
           has_scale == o.has_scale && scale == o.scale &&
           nullable == o.nullable;
  }
  bool is_floating() const {
    return name == "FLOAT" || name == "DOUBLE" || name == "REAL" ||
           name == "DECIMAL";
  }
};

struct Field {
  std::string name;
  SqlType stype;
};

struct Rel;
using RelP = std::shared_ptr<const Rel>;

struct Rex;
using RexP = std::shared_ptr<const Rex>;

struct Rex {
  enum Kind { INPUT, LIT, CALL, SUBQ } kind = INPUT;
  SqlType stype;

  // INPUT
  int64_t index = 0;

  // LIT
  enum LKind { L_NULL, L_BOOL, L_INT, L_DBL, L_STR } lkind = L_NULL;
  bool bval = false;
  int64_t ival = 0;
  double dval = 0.0;
  std::string sval;

  // CALL
  std::string op;
  std::vector<RexP> operands;
  bool has_info = false;
  SqlType info;

  // SUBQ
  RelP plan;

  static RexP input_ref(int64_t idx, const SqlType& t);
  static RexP literal_bool(bool v, const SqlType& t);
  static RexP literal_int(int64_t v, const SqlType& t);
  static RexP call(const std::string& op, std::vector<RexP> ops,
                   const SqlType& t);
  static RexP call_info(const std::string& op, std::vector<RexP> ops,
                        const SqlType& t, const SqlType& info);

  bool is_true_literal() const {
    return kind == LIT && lkind == L_BOOL && bval;
  }
};

bool rex_equal(const RexP& a, const RexP& b);

struct AggCall {
  std::string op;
  std::vector<int64_t> args;
  bool distinct = false;
  SqlType stype;
  std::string name;
  bool has_filter = false;
  int64_t filter_arg = 0;
};

struct SortCollation {
  int64_t index = 0;
  bool ascending = true;
  int nulls_first = -1;  // -1 = None (postgres default), 0 = false, 1 = true
};

struct WindowCall {
  std::string op;
  std::vector<int64_t> args;
  std::vector<int64_t> partition;
  std::vector<SortCollation> order;
  JVP frame;  // opaque (round-tripped untouched)
  SqlType stype;
  std::string name;
};

struct Rel {
  enum Kind {
    SCAN, PROJECT, FILTER, AGG, JOIN, SORT,
    UNION, INTERSECT, EXCEPT, VALUES, WINDOW, SAMPLE
  } kind = SCAN;
  std::vector<Field> schema;

  // SCAN
  std::string schema_name, table_name;
  // PROJECT
  std::vector<RexP> exprs;
  // FILTER / JOIN condition (null allowed on JOIN)
  RexP condition;
  // AGG
  std::vector<int64_t> group_keys;
  std::vector<AggCall> aggs;
  // JOIN
  RelP left, right;
  std::string join_type = "INNER";
  bool null_aware = false;
  // single-input nodes (PROJECT/FILTER/AGG/SORT/WINDOW/SAMPLE)
  RelP input;
  // SORT
  std::vector<SortCollation> collation;
  bool has_limit = false;
  int64_t limit = 0;
  bool has_offset = false;
  int64_t offset = 0;
  // set ops
  std::vector<RelP> set_inputs;
  bool all_flag = false;
  // VALUES
  std::vector<std::vector<RexP>> rows;
  // WINDOW
  std::vector<WindowCall> calls;
  // SAMPLE
  std::string method = "BERNOULLI";
  double percentage = 100.0;
  bool has_seed = false;
  int64_t seed = 0;

  std::vector<RelP> inputs() const;
  RelP with_inputs(const std::vector<RelP>& ins) const;
};

// construction helpers (mirror the Python dataclass constructors)
RelP make_project(RelP in, std::vector<RexP> exprs, std::vector<Field> schema);
RelP make_filter(RelP in, RexP cond, std::vector<Field> schema);
RelP make_join(RelP l, RelP r, const std::string& jt, RexP cond,
               std::vector<Field> schema, bool null_aware);
RelP make_aggregate(RelP in, std::vector<int64_t> gk, std::vector<AggCall> aggs,
                    std::vector<Field> schema);

// wire conversion
SqlType type_from_json(const JVP& v);
JVP type_to_json(const SqlType& t);
RexP rex_from_json(const JVP& v);
JVP rex_to_json(const RexP& r);
RelP rel_from_json(const JVP& v);
JVP rel_to_json(const RelP& r);

// rex utilities (mirror nodes.py)
void rex_inputs(const RexP& r, std::vector<int64_t>& out);
std::vector<int64_t> rex_inputs(const RexP& r);
RexP remap_rex(const RexP& r, const std::map<int64_t, int64_t>& mapping);

// the optimizer entry (optimizer.cpp)
RelP optimize_plan(RelP plan, bool enable_pruning);

}  // namespace dsql
