// Minimal JSON DOM for the native planner: parse + emit with int64/double
// distinction preserved (plan ordinals and literals must round-trip exactly).
// The parser front-end (parser.cpp) only EMITS JSON; the optimizer
// (optimizer.cpp) must also READ plans serialized by the Python bridge
// (dask_sql_tpu/plan/native_planner.py), hence this DOM.
#pragma once

#include <cstdint>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace dsql {

struct JV;
using JVP = std::shared_ptr<JV>;

struct JsonError : std::runtime_error {
  explicit JsonError(const std::string& m) : std::runtime_error(m) {}
};

struct JV {
  enum Kind { NUL, BOOL, INT, DBL, STR, ARR, OBJ } kind = NUL;
  bool b = false;
  int64_t i = 0;
  double d = 0.0;
  std::string s;
  std::vector<JVP> arr;
  // insertion-ordered object (plans are emitted with stable key order)
  std::vector<std::pair<std::string, JVP>> obj;

  static JVP null() { return std::make_shared<JV>(); }
  static JVP boolean(bool v) {
    auto j = std::make_shared<JV>(); j->kind = BOOL; j->b = v; return j;
  }
  static JVP integer(int64_t v) {
    auto j = std::make_shared<JV>(); j->kind = INT; j->i = v; return j;
  }
  static JVP dbl(double v) {
    auto j = std::make_shared<JV>(); j->kind = DBL; j->d = v; return j;
  }
  static JVP str(const std::string& v) {
    auto j = std::make_shared<JV>(); j->kind = STR; j->s = v; return j;
  }
  static JVP array() {
    auto j = std::make_shared<JV>(); j->kind = ARR; return j;
  }
  static JVP object() {
    auto j = std::make_shared<JV>(); j->kind = OBJ; return j;
  }

  void push(const JVP& v) { arr.push_back(v); }
  void set(const std::string& k, const JVP& v) { obj.emplace_back(k, v); }

  const JVP* find(const std::string& k) const {
    for (const auto& kv : obj)
      if (kv.first == k) return &kv.second;
    return nullptr;
  }
  const JVP& at(const std::string& k) const {
    const JVP* p = find(k);
    if (!p) throw JsonError("missing key: " + k);
    return *p;
  }
  int64_t as_int() const {
    if (kind == INT) return i;
    if (kind == DBL) return (int64_t)d;
    throw JsonError("not an int");
  }
  double as_double() const {
    if (kind == DBL) return d;
    if (kind == INT) return (double)i;
    throw JsonError("not a number");
  }
  const std::string& as_str() const {
    if (kind != STR) throw JsonError("not a string");
    return s;
  }
  bool as_bool() const {
    if (kind != BOOL) throw JsonError("not a bool");
    return b;
  }
  bool is_null() const { return kind == NUL; }
};

JVP json_parse(const std::string& text);
std::string json_emit(const JVP& v);

}  // namespace dsql
