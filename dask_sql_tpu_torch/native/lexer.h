// SQL lexer: text -> token stream with line/col positions.
//
// Native counterpart of dask_sql_tpu/sql/lexer.py — the reference keeps its
// whole parser stack native (Java/Calcite, planner/src/main/codegen); here the
// native planner front-end is C++.  Dialect decisions follow the reference's
// DaskSqlDialect (DaskSqlDialect.java:25-26): unquoted identifiers KEEP their
// case, keywords are case-insensitive, quoted identifiers use double quotes or
// backticks, strings use single quotes with '' escaping.
#pragma once

#include <string>
#include <vector>

namespace dsql {

enum class Tk { IDENT, QIDENT, STRING, NUMBER, OP, END };

struct Token {
  Tk kind;
  std::string text;   // raw text (identifier case preserved; string unescaped)
  std::string upper;  // ASCII upper-case of text (for keyword matching)
  int line = 0, col = 0;
};

struct LexError {
  std::string msg;
  int line, col;
};

// Tokenize `sql`; throws LexError on bad input. Appends an END token.
std::vector<Token> tokenize(const std::string& sql);

}  // namespace dsql
