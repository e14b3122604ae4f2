// C API for the native SQL planner front-end (loaded from Python via ctypes —
// no pybind11 dependency; the reference exposes its
// native planner to Python through an in-process bridge the same way, via
// JPype: upstream dask_sql/java.py:62-98).
//
// Contract:
//   dsql_parse(sql) -> malloc'd UTF-8 JSON string, either
//     {"ok": <statement array>}  or
//     {"error": {"msg": ..., "line": N, "col": N, "width": N}}
//   The caller must release the result with dsql_free().
//   dsql_optimize(plan_json, enable_pruning) -> malloc'd UTF-8 JSON string,
//     {"ok": <optimized plan>} or {"error": {"msg": ...}} — the native rule
//     optimizer (optimizer.cpp), lockstep with plan/optimizer.py.
#include <cstdlib>
#include <cstring>
#include <string>

#include "json.h"
#include "lexer.h"
#include "parser.h"
#include "plan.h"

namespace {

using dsql::json_quote;

char* dup_string(const std::string& s) {
  char* out = (char*)std::malloc(s.size() + 1);
  if (out) std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

std::string error_json(const std::string& msg, int line, int col, int width) {
  return "{\"error\":{\"msg\":" + json_quote(msg) + ",\"line\":" + std::to_string(line) +
         ",\"col\":" + std::to_string(col) + ",\"width\":" + std::to_string(width) +
         "}}";
}

}  // namespace

extern "C" {

const char* dsql_version() { return "1"; }

char* dsql_parse(const char* sql) {
  try {
    std::string result = dsql::parse_statements_json(sql ? sql : "");
    return dup_string("{\"ok\":" + result + "}");
  } catch (const dsql::ParseError& e) {
    return dup_string(error_json(e.msg, e.line, e.col, e.width));
  } catch (const dsql::LexError& e) {
    return dup_string(error_json(e.msg, e.line, e.col, 1));
  } catch (const std::exception& e) {
    return dup_string(error_json(std::string("internal: ") + e.what(), 1, 1, 1));
  } catch (...) {
    return dup_string(error_json("internal: unknown error", 1, 1, 1));
  }
}

void dsql_free(char* p) { std::free(p); }

char* dsql_optimize(const char* plan_json, int enable_pruning) {
  try {
    dsql::JVP doc = dsql::json_parse(plan_json ? plan_json : "");
    dsql::RelP plan = dsql::rel_from_json(doc);
    dsql::RelP out = dsql::optimize_plan(plan, enable_pruning != 0);
    return dup_string("{\"ok\":" + dsql::json_emit(dsql::rel_to_json(out)) +
                      "}");
  } catch (const std::exception& e) {
    return dup_string(error_json(std::string("optimize: ") + e.what(), 1, 1,
                                 1));
  } catch (...) {
    return dup_string(error_json("optimize: unknown error", 1, 1, 1));
  }
}

}  // extern "C"
