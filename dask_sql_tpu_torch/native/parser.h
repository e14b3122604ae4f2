// Native SQL parser: tokens -> AST serialized as JSON.
//
// C++ counterpart of dask_sql_tpu/sql/parser.py, mirroring the reference's
// native planner front-end (Java/Calcite + the custom statement grammar in
// planner/src/main/codegen/includes/{create,model,show,utils}.ftl).  The JSON
// shape is one object per AST node: {"t": "<ClassName>", <field>: <value>...}
// with field names identical to the dataclasses in dask_sql_tpu/sql/ast.py,
// so the Python bridge reconstructs the exact same AST the Python parser
// produces.
#pragma once

#include <string>

namespace dsql {

struct ParseError {
  std::string msg;  // already includes the "(got ...)" suffix
  int line, col, width;
};

// Parse one-or-more ;-separated statements; returns a JSON array of
// statement nodes. Throws ParseError or LexError.
std::string parse_statements_json(const std::string& sql);

// JSON-escape a string, including the surrounding quotes.
std::string json_quote(const std::string& s);

}  // namespace dsql
