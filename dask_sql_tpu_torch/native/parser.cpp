#include "parser.h"

#include <cctype>
#include <cmath>
#include <initializer_list>
#include <set>
#include <sstream>
#include <string>
#include <vector>

#include "lexer.h"

namespace dsql {

std::string json_quote(const std::string& s) {
  std::string out = "\"";
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out += (char)c;
        }
    }
  }
  out += '"';
  return out;
}

namespace {

// Words that terminate expressions / cannot be bare identifiers in most spots
// (must stay in lock-step with RESERVED in dask_sql_tpu/sql/parser.py).
const std::set<std::string> kReserved = {
    "SELECT", "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET",
    "UNION", "INTERSECT", "EXCEPT", "JOIN", "INNER", "LEFT", "RIGHT", "FULL",
    "CROSS", "ON", "USING", "AS", "AND", "OR", "NOT", "CASE", "WHEN", "THEN",
    "ELSE", "END", "IS", "NULL", "TRUE", "FALSE", "BETWEEN", "IN", "LIKE",
    "ILIKE", "SIMILAR", "EXISTS", "DISTINCT", "ALL", "ANY", "SOME", "BY",
    "ASC", "DESC", "NULLS", "FIRST", "LAST", "CAST", "INTERVAL", "CREATE",
    "DROP", "SHOW", "DESCRIBE", "ANALYZE", "WITH", "VALUES", "OVER",
    "PARTITION", "TABLESAMPLE", "FETCH", "FILTER", "TO", "FOR",
    "NATURAL",  // else the table-alias rule swallows it before join parsing
};

const std::set<std::string> kComparisons = {"=", "<>", "!=", "<", "<=", ">", ">="};
const std::set<std::string> kJoinTypes = {"INNER", "LEFT", "RIGHT", "FULL", "CROSS"};

// ----------------------------------------------------------------- JSON utils

std::string jstr(const std::string& s) { return json_quote(s); }

// Emit a SQL NUMBER token verbatim as a JSON number.  json.loads applies the
// same int-vs-float rule as the Python parser's _number_value ('.'/'e' =>
// float), so round-tripping the raw text preserves exact semantics, incl.
// arbitrary-precision integers.  "1." / ".5" / "1.e5" are valid SQL but not
// valid JSON; pad with a zero (same numeric value).
std::string jnum(std::string t) {
  if (!t.empty() && t[0] == '.') t = "0" + t;
  size_t d = t.find('.');
  if (d != std::string::npos &&
      (d + 1 == t.size() || !std::isdigit((unsigned char)t[d + 1])))
    t.insert(d + 1, "0");
  return t;
}

bool number_is_float(const std::string& t) {
  return t.find('.') != std::string::npos || t.find('e') != std::string::npos ||
         t.find('E') != std::string::npos;
}

std::string join(const std::vector<std::string>& items, const char* sep = ",") {
  std::string out;
  for (size_t i = 0; i < items.size(); ++i) {
    if (i) out += sep;
    out += items[i];
  }
  return out;
}

std::string jarr(const std::vector<std::string>& items) {
  return "[" + join(items) + "]";
}

std::string jstrarr(const std::vector<std::string>& raw) {
  std::vector<std::string> q;
  q.reserve(raw.size());
  for (const auto& s : raw) q.push_back(jstr(s));
  return jarr(q);
}

// ------------------------------------------------------------------- parser

class Parser {
 public:
  explicit Parser(const std::string& sql) : sql_(sql), tokens_(tokenize(sql)) {}

  std::string parse_statements() {
    std::vector<std::string> stmts;
    while (cur().kind != Tk::END) {
      stmts.push_back(parse_statement());
      while (eat_op(";")) {
      }
    }
    return jarr(stmts);
  }

 private:
  const std::string& sql_;
  std::vector<Token> tokens_;
  size_t i_ = 0;
  // ``?`` markers number left to right in token order, as in the Python
  // parser
  int param_seq_ = 0;

  // --------------------------------------------------------------- helpers
  // Clamped like peek(): tokenize() always appends an END token, so running
  // past the end must keep returning it, never read out of bounds.
  const Token& cur() const {
    return tokens_[i_ < tokens_.size() ? i_ : tokens_.size() - 1];
  }
  const Token& peek(size_t k = 0) const {
    size_t j = i_ + k;
    if (j >= tokens_.size()) j = tokens_.size() - 1;
    return tokens_[j];
  }
  bool at_kw(std::initializer_list<const char*> words, size_t k = 0) const {
    const Token& t = peek(k);
    if (t.kind != Tk::IDENT) return false;
    for (const char* w : words)
      if (t.upper == w) return true;
    return false;
  }
  bool at_op(std::initializer_list<const char*> ops, size_t k = 0) const {
    const Token& t = peek(k);
    if (t.kind != Tk::OP) return false;
    for (const char* o : ops)
      if (t.text == o) return true;
    return false;
  }
  std::string eat_kw(std::initializer_list<const char*> words) {
    if (at_kw(words)) {
      std::string w = cur().upper;
      ++i_;
      return w;
    }
    return "";
  }
  std::string eat_op(std::initializer_list<const char*> ops) {
    if (at_op(ops)) {
      std::string o = cur().text;
      ++i_;
      return o;
    }
    return "";
  }
  bool eat_op(const char* op) { return !eat_op({op}).empty(); }
  std::string expect_kw(std::initializer_list<const char*> words) {
    std::string w = eat_kw(words);
    if (w.empty()) {
      std::vector<std::string> ws(words.begin(), words.end());
      error("Expected " + join(ws, " or "));
    }
    return w;
  }
  void expect_op(const char* op) {
    if (!eat_op(op)) error(std::string("Expected '") + op + "'");
  }
  [[noreturn]] void error(const std::string& message) const { error(message, cur()); }
  [[noreturn]] void error(const std::string& message, const Token& t) const {
    std::string got = t.kind != Tk::END ? t.text : "end of statement";
    int width = (int)t.text.size();
    throw ParseError{message + " (got '" + got + "')", t.line, t.col,
                     width > 1 ? width : 1};
  }

  std::string identifier(const char* what = "identifier") {
    const Token& t = cur();
    if (t.kind == Tk::QIDENT) {
      ++i_;
      return t.text;
    }
    if (t.kind == Tk::IDENT && !kReserved.count(t.upper)) {
      ++i_;
      return t.text;
    }
    error(std::string("Expected ") + what);
  }
  std::string any_identifier() {
    const Token& t = cur();
    if (t.kind == Tk::IDENT || t.kind == Tk::QIDENT) {
      ++i_;
      return t.text;
    }
    error("Expected identifier");
  }
  std::vector<std::string> compound_identifier() {
    std::vector<std::string> parts{identifier()};
    while (eat_op(".")) parts.push_back(any_identifier());
    return parts;
  }
  std::string pos_of(const Token& t) const {
    return "[" + std::to_string(t.line) + "," + std::to_string(t.col) + "]";
  }
  std::string pos_here() const { return pos_of(cur()); }

  // ------------------------------------------------------------ statements
  std::string parse_statement() {
    const Token& t = cur();
    if (t.kind == Tk::IDENT) {
      const std::string& u = t.upper;
      if (u == "CREATE") return parse_create();
      if (u == "DROP") return parse_drop();
      if (u == "SHOW") return parse_show();
      if (u == "DESCRIBE" || u == "DESC") return parse_describe();
      if (u == "ANALYZE") return parse_analyze();
      if (u == "USE") return parse_use();
      if (u == "EXPORT") return parse_export();
      if (u == "EXPLAIN") {
        std::string pos = pos_of(t);
        ++i_;
        return R"({"t":"ExplainStatement","query":)" + parse_query() +
               ",\"pos\":" + pos + "}";
      }
    }
    if ((t.kind == Tk::IDENT &&
         (t.upper == "SELECT" || t.upper == "WITH" || t.upper == "VALUES")) ||
        at_op({"("}))
      return R"({"t":"QueryStatement","query":)" + parse_query() + "}";
    error("Expected a SQL statement");
  }

  std::string parse_create() {
    std::string pos = pos_here();
    expect_kw({"CREATE"});
    bool or_replace = false;
    if (!eat_kw({"OR"}).empty()) {
      expect_kw({"REPLACE"});
      or_replace = true;
    }
    std::string kind = expect_kw({"TABLE", "VIEW", "MODEL", "SCHEMA", "EXPERIMENT"});
    bool if_not_exists = false;
    if (!eat_kw({"IF"}).empty()) {
      expect_kw({"NOT"});
      expect_kw({"EXISTS"});
      if_not_exists = true;
    }
    auto flags = [&] {
      return std::string(",\"if_not_exists\":") + (if_not_exists ? "true" : "false") +
             ",\"or_replace\":" + (or_replace ? "true" : "false") + ",\"pos\":" + pos;
    };
    if (kind == "SCHEMA") {
      std::string name = identifier("schema name");
      return R"({"t":"CreateSchema","name":)" + jstr(name) + flags() + "}";
    }
    std::string name = jstrarr(compound_identifier());
    if (kind == "MODEL" || kind == "EXPERIMENT") {
      std::string kwargs = "{}";
      if (!eat_kw({"WITH"}).empty()) kwargs = parse_kwargs();
      expect_kw({"AS"});
      std::string query = parse_parenthesized_or_plain_query();
      const char* cls = kind == "MODEL" ? "CreateModel" : "CreateExperiment";
      return std::string("{\"t\":\"") + cls + "\",\"name\":" + name +
             ",\"kwargs\":" + kwargs + ",\"query\":" + query + flags() + "}";
    }
    // TABLE or VIEW
    if (!eat_kw({"WITH"}).empty()) {
      std::string kwargs = parse_kwargs();
      return R"({"t":"CreateTable","name":)" + name + ",\"kwargs\":" + kwargs +
             flags() + "}";
    }
    expect_kw({"AS"});
    std::string query = parse_parenthesized_or_plain_query();
    return R"({"t":"CreateTableAs","name":)" + name + ",\"query\":" + query +
           flags() + ",\"view\":" + (kind == "VIEW" ? "true" : "false") + "}";
  }

  std::string parse_parenthesized_or_plain_query() {
    if (at_op({"("})) {
      expect_op("(");
      std::string q = parse_query();
      expect_op(")");
      return q;
    }
    return parse_query();
  }

  // kwargs dict syntax (reference utils.ftl:1-136): plain JSON object; MAP
  // values become {"__map__": [k,v,k,v...]} (keys may be non-strings).
  std::string parse_kwargs() {
    expect_op("(");
    std::vector<std::string> items;
    if (!at_op({")"})) {
      for (;;) {
        std::string key = any_identifier();
        expect_op("=");
        items.push_back(jstr(key) + ":" + parse_kwarg_value());
        if (!eat_op(",")) break;
      }
    }
    expect_op(")");
    return "{" + join(items) + "}";
  }

  std::string parse_kwarg_value() {
    const Token& t = cur();
    if (at_op({"("})) return parse_kwargs();  // nested dict (MULTISET form)
    if (at_kw({"ARRAY"})) {
      ++i_;
      expect_op("[");
      std::vector<std::string> vals;
      if (!at_op({"]"})) {
        for (;;) {
          vals.push_back(parse_kwarg_value());
          if (!eat_op(",")) break;
        }
      }
      expect_op("]");
      return jarr(vals);
    }
    if (at_kw({"MAP"})) {
      ++i_;
      expect_op("[");
      std::vector<std::string> items;
      if (!at_op({"]"})) {
        for (;;) {
          items.push_back(parse_kwarg_value());
          if (!eat_op(",")) break;
        }
      }
      expect_op("]");
      return R"({"__map__":)" + jarr(items) + "}";
    }
    if (t.kind == Tk::STRING) {
      ++i_;
      return jstr(t.text);
    }
    if (t.kind == Tk::NUMBER) {
      ++i_;
      return jnum(t.text);
    }
    if (eat_op("-")) {
      const Token& t2 = cur();
      if (t2.kind == Tk::NUMBER) {
        ++i_;
        return "-" + jnum(t2.text);
      }
      error("Expected number");
    }
    if (t.kind == Tk::IDENT) {
      std::string u = t.upper;
      ++i_;
      if (u == "TRUE") return "true";
      if (u == "FALSE") return "false";
      if (u == "NULL") return "null";
      return jstr(t.text);  // bare identifier value, e.g. format = csv
    }
    error("Expected kwarg value");
  }

  std::string parse_drop() {
    std::string pos = pos_here();
    expect_kw({"DROP"});
    std::string kind = expect_kw({"TABLE", "MODEL", "SCHEMA", "VIEW"});
    bool if_exists = false;
    if (!eat_kw({"IF"}).empty()) {
      expect_kw({"EXISTS"});
      if_exists = true;
    }
    std::string fl = std::string(",\"if_exists\":") + (if_exists ? "true" : "false") +
                     ",\"pos\":" + pos + "}";
    if (kind == "SCHEMA")
      return R"({"t":"DropSchema","name":)" + jstr(identifier()) + fl;
    std::string name = jstrarr(compound_identifier());
    if (kind == "MODEL") return R"({"t":"DropModel","name":)" + name + fl;
    return R"({"t":"DropTable","name":)" + name + fl;
  }

  std::string parse_show() {
    std::string pos = pos_here();
    expect_kw({"SHOW"});
    std::string kind = expect_kw({"SCHEMAS", "TABLES", "COLUMNS", "MODELS"});
    if (kind == "SCHEMAS") {
      std::string like = "null";
      if (!eat_kw({"LIKE"}).empty()) {
        if (cur().kind != Tk::STRING)
          error("Expected a string literal after LIKE");
        like = jstr(cur().text);
        ++i_;
      }
      return R"({"t":"ShowSchemas","like":)" + like + ",\"pos\":" + pos + "}";
    }
    if (kind == "TABLES") {
      std::string schema = "null";
      if (!eat_kw({"FROM", "IN"}).empty()) schema = jstr(identifier());
      return R"({"t":"ShowTables","schema":)" + schema + ",\"pos\":" + pos + "}";
    }
    if (kind == "COLUMNS") {
      expect_kw({"FROM", "IN"});
      return R"({"t":"ShowColumns","table":)" + jstrarr(compound_identifier()) +
             ",\"pos\":" + pos + "}";
    }
    return R"({"t":"ShowModels","pos":)" + pos + "}";
  }

  std::string parse_describe() {
    std::string pos = pos_here();
    ++i_;  // DESCRIBE / DESC
    if (!eat_kw({"MODEL"}).empty())
      return R"({"t":"DescribeModel","name":)" + jstrarr(compound_identifier()) +
             ",\"pos\":" + pos + "}";
    eat_kw({"TABLE"});
    return R"({"t":"DescribeTable","table":)" + jstrarr(compound_identifier()) +
           ",\"pos\":" + pos + "}";
  }

  std::string parse_analyze() {
    std::string pos = pos_here();
    expect_kw({"ANALYZE"});
    expect_kw({"TABLE"});
    std::string table = jstrarr(compound_identifier());
    std::string columns = "null";
    expect_kw({"COMPUTE"});
    expect_kw({"STATISTICS"});
    if (!eat_kw({"FOR"}).empty()) {
      if (!eat_kw({"ALL"}).empty()) {
        expect_kw({"COLUMNS"});
      } else {
        expect_kw({"COLUMNS"});
        std::vector<std::string> cols{identifier()};
        while (eat_op(",")) cols.push_back(identifier());
        columns = jstrarr(cols);
      }
    }
    return R"({"t":"AnalyzeTable","table":)" + table + ",\"columns\":" + columns +
           ",\"pos\":" + pos + "}";
  }

  std::string parse_use() {
    std::string pos = pos_here();
    expect_kw({"USE"});
    expect_kw({"SCHEMA"});
    return R"({"t":"UseSchema","name":)" + jstr(identifier()) + ",\"pos\":" + pos + "}";
  }

  std::string parse_export() {
    std::string pos = pos_here();
    expect_kw({"EXPORT"});
    expect_kw({"MODEL"});
    std::string name = jstrarr(compound_identifier());
    std::string kwargs = "{}";
    if (!eat_kw({"WITH"}).empty()) kwargs = parse_kwargs();
    return R"({"t":"ExportModel","name":)" + name + ",\"kwargs\":" + kwargs +
           ",\"pos\":" + pos + "}";
  }

  // --------------------------------------------------------------- queries

  // A parsed query body, pre-assembly, so ORDER/LIMIT/OFFSET/CTEs can be
  // merged the same way the python parser mutates the dataclasses in
  // parse_query before the result is consumed.
  struct SelectParts {
    enum Kind { SELECT, SETOP, RAW } kind = RAW;
    // SELECT fields:
    std::string projections, distinct, from_, where, group_by, having, pos;
    std::vector<std::string> ctes;  // serialized [name, query] pairs
    // shared by SELECT and SETOP:
    std::string order_by = "[]", limit = "null", offset = "null";
    // SETOP: JSON prefix lacking order_by/limit/offset and the closing brace.
    std::string raw_prefix;
    // RAW: complete JSON (ValuesQuery)
    std::string raw;
  };

  std::string select_json(const SelectParts& s) {
    return R"({"t":"Select","projections":)" + s.projections +
           ",\"distinct\":" + s.distinct + ",\"from_\":" + s.from_ +
           ",\"where\":" + s.where + ",\"group_by\":" + s.group_by +
           ",\"having\":" + s.having + ",\"order_by\":" + s.order_by +
           ",\"limit\":" + s.limit + ",\"offset\":" + s.offset +
           ",\"ctes\":[" + join(s.ctes) + "],\"pos\":" + s.pos + "}";
  }

  // Serialize a SelectParts as a complete JSON node.
  std::string finish_parts(const SelectParts& p) {
    if (p.kind == SelectParts::SELECT) return select_json(p);
    if (p.kind == SelectParts::SETOP)
      return p.raw_prefix + ",\"order_by\":" + p.order_by + ",\"limit\":" + p.limit +
             ",\"offset\":" + p.offset + "}";
    return p.raw;
  }

  std::string parse_query() { return finish_parts(parse_query_parts()); }

  SelectParts parse_query_parts() {
    std::vector<std::string> ctes;  // [name, query] pairs
    if (at_kw({"WITH"})) {
      ++i_;
      for (;;) {
        std::string name = identifier("CTE name");
        expect_kw({"AS"});
        expect_op("(");
        ctes.push_back("[" + jstr(name) + "," + parse_query() + "]");
        expect_op(")");
        if (!eat_op(",")) break;
      }
    }
    SelectParts body = parse_set_expr();
    std::string order_by, limit, offset;
    parse_order_limit(order_by, limit, offset);

    if (body.kind == SelectParts::SELECT && body.order_by == "[]") {
      body.ctes.insert(body.ctes.begin(), ctes.begin(), ctes.end());
      body.order_by = order_by;
      if (body.limit == "null") body.limit = limit;
      if (body.offset == "null") body.offset = offset;
      return body;
    }
    bool raw_needs_wrap =
        body.kind == SelectParts::RAW &&
        (order_by != "[]" || limit != "null" || offset != "null");
    bool needs_wrap =
        (!ctes.empty() && body.kind != SelectParts::SELECT) || raw_needs_wrap;
    if (body.kind == SelectParts::SETOP && !needs_wrap) {
      body.order_by = order_by;
      body.limit = limit;
      body.offset = offset;
    }
    if (needs_wrap) {
      // wrap in a Select to carry the CTEs and/or outer ORDER BY/LIMIT
      SelectParts sel;
      sel.kind = SelectParts::SELECT;
      sel.projections = R"([[{"t":"Star","table":null,"pos":[0,0]},null]])";
      sel.distinct = "false";
      sel.from_ = R"({"t":"SubqueryRelation","query":)" + finish_parts(body) +
                  R"(,"alias":"__cte_body__","column_aliases":null,"pos":[0,0]})";
      sel.where = "null";
      sel.group_by = "null";
      sel.having = "null";
      sel.pos = "[0,0]";
      sel.ctes = ctes;
      sel.order_by = order_by;
      sel.limit = limit;
      sel.offset = offset;
      return sel;
    }
    return body;
  }

  void parse_order_limit(std::string& order_by, std::string& limit,
                         std::string& offset) {
    std::vector<std::string> keys;
    limit = "null";
    offset = "null";
    if (at_kw({"ORDER"})) {
      ++i_;
      expect_kw({"BY"});
      for (;;) {
        keys.push_back(parse_sort_key());
        if (!eat_op(",")) break;
      }
    }
    if (!eat_kw({"LIMIT"}).empty()) limit = parse_expr();
    if (!eat_kw({"OFFSET"}).empty()) {
      offset = parse_expr();
      eat_kw({"ROWS", "ROW"});
    }
    if (!eat_kw({"FETCH"}).empty()) {
      expect_kw({"FIRST", "NEXT"});
      limit = parse_expr();
      eat_kw({"ROWS", "ROW"});
      expect_kw({"ONLY"});
    }
    order_by = jarr(keys);
  }

  std::string parse_sort_key() {
    std::string e = parse_expr();
    bool asc = true;
    if (!eat_kw({"DESC"}).empty())
      asc = false;
    else
      eat_kw({"ASC"});
    std::string nulls_first = "null";
    if (!eat_kw({"NULLS"}).empty())
      nulls_first = expect_kw({"FIRST", "LAST"}) == "FIRST" ? "true" : "false";
    return R"({"t":"SortKey","expr":)" + e + ",\"ascending\":" +
           (asc ? "true" : "false") + ",\"nulls_first\":" + nulls_first + "}";
  }

  SelectParts parse_set_expr() { return parse_set_tail(parse_select_core()); }

  // chain set ops onto a parsed left-hand side (no-op if none follow)
  SelectParts parse_set_tail(SelectParts left) {
    for (;;) {
      std::string pos = pos_here();
      std::string op = eat_kw({"UNION", "INTERSECT", "EXCEPT", "MINUS"});
      if (op.empty()) return left;
      if (op == "MINUS") op = "EXCEPT";
      bool all = !eat_kw({"ALL"}).empty();
      if (!all) eat_kw({"DISTINCT"});
      SelectParts right = parse_select_core();
      std::string lj = finish_parts(left), rj = finish_parts(right);
      SelectParts so;
      so.kind = SelectParts::SETOP;
      so.raw_prefix = R"({"t":"SetOp","op":)" + jstr(op) + ",\"all\":" +
                      (all ? "true" : "false") + ",\"left\":" + lj +
                      ",\"right\":" + rj + ",\"pos\":" + pos;
      left = std::move(so);
    }
  }

  SelectParts parse_select_core() {
    SelectParts out;
    if (at_op({"("})) {
      expect_op("(");
      std::string q = parse_query();
      expect_op(")");
      out.raw = q;
      return out;
    }
    std::string pos = pos_here();
    if (at_kw({"VALUES"})) {
      ++i_;
      std::vector<std::string> rows;
      for (;;) {
        expect_op("(");
        std::vector<std::string> row{parse_expr()};
        while (eat_op(",")) row.push_back(parse_expr());
        expect_op(")");
        rows.push_back(jarr(row));
        if (!eat_op(",")) break;
      }
      out.raw = R"({"t":"ValuesQuery","rows":)" + jarr(rows) + ",\"pos\":" + pos + "}";
      return out;
    }
    if (at_kw({"WITH"})) {
      out.raw = parse_query();
      return out;
    }
    expect_kw({"SELECT"});
    bool distinct = false;
    if (!eat_kw({"DISTINCT"}).empty())
      distinct = true;
    else
      eat_kw({"ALL"});
    std::vector<std::string> projections;
    for (;;) {
      std::string proj_pos = pos_here();
      if (at_op({"*"})) {
        ++i_;
        projections.push_back(R"([{"t":"Star","table":null,"pos":)" + proj_pos +
                              "},null]");
      } else {
        std::string e = parse_expr();
        std::string alias = "null";
        if (!eat_kw({"AS"}).empty()) {
          alias = jstr(any_identifier());
        } else if (cur().kind == Tk::QIDENT ||
                   (cur().kind == Tk::IDENT && !kReserved.count(cur().upper))) {
          alias = jstr(cur().text);
          ++i_;
        }
        projections.push_back("[" + e + "," + alias + "]");
      }
      if (!eat_op(",")) break;
    }
    out.kind = SelectParts::SELECT;
    out.projections = jarr(projections);
    out.distinct = distinct ? "true" : "false";
    out.pos = pos;
    out.from_ = "null";
    out.where = "null";
    out.group_by = "null";
    out.having = "null";
    if (!eat_kw({"FROM"}).empty()) out.from_ = parse_relation();
    if (!eat_kw({"WHERE"}).empty()) out.where = parse_expr();
    if (at_kw({"GROUP"})) {
      ++i_;
      expect_kw({"BY"});
      std::vector<std::string> gb;
      for (;;) {
        if (eat_op("(")) {
          if (!eat_op(")")) {  // GROUP BY () = empty grouping set
            gb.push_back(parse_expr());
            while (eat_op(",")) gb.push_back(parse_expr());
            expect_op(")");
          }
        } else {
          gb.push_back(parse_expr());
        }
        if (!eat_op(",")) break;
      }
      out.group_by = jarr(gb);
    }
    if (!eat_kw({"HAVING"}).empty()) out.having = parse_expr();
    return out;
  }

  // -------------------------------------------------------------- relations
  std::string parse_relation() {
    std::string left = parse_table_factor();
    for (;;) {
      std::string pos = pos_here();
      if (eat_op(",")) {
        std::string right = parse_table_factor();
        left = R"({"t":"JoinRelation","left":)" + left + ",\"right\":" + right +
               R"(,"join_type":"CROSS","condition":null,"using":null,"pos":)" +
               pos + "}";
        continue;
      }
      std::string jt;
      bool natural = false;
      if (at_kw({"NATURAL"})) {
        ++i_;
        natural = true;
      }
      if (at_kw({"JOIN"})) {
        jt = "INNER";
        ++i_;
      } else if (at_kw({"INNER", "LEFT", "RIGHT", "FULL", "CROSS"})) {
        jt = cur().upper;
        ++i_;
        eat_kw({"OUTER"});
        expect_kw({"JOIN"});
      } else {
        if (natural) error("Expected JOIN after NATURAL");
        return left;
      }
      std::string right = parse_table_factor();
      std::string cond = "null";
      std::string using_ = "null";
      if (jt != "CROSS" && !natural) {
        if (!eat_kw({"ON"}).empty()) {
          cond = parse_expr();
        } else if (!eat_kw({"USING"}).empty()) {
          expect_op("(");
          std::vector<std::string> cols{identifier()};
          while (eat_op(",")) cols.push_back(identifier());
          expect_op(")");
          using_ = jstrarr(cols);
        } else {
          error("Expected ON or USING after JOIN");
        }
      }
      if (natural) using_ = jstr("NATURAL");  // resolved by the binder
      left = R"({"t":"JoinRelation","left":)" + left + ",\"right\":" + right +
             ",\"join_type\":" + jstr(jt) + ",\"condition\":" + cond +
             ",\"using\":" + using_ + ",\"pos\":" + pos + "}";
    }
  }

  std::string parse_table_factor() {
    std::string pos = pos_here();
    if (at_op({"("})) {
      expect_op("(");
      if (at_kw({"SELECT", "WITH", "VALUES"}) || at_op({"("})) {
        std::string q = parse_query();
        expect_op(")");
        std::string alias, cols;
        parse_alias(alias, cols);
        return R"({"t":"SubqueryRelation","query":)" + q + ",\"alias\":" + alias +
               ",\"column_aliases\":" + cols + ",\"pos\":" + pos + "}";
      }
      std::string rel = parse_relation();
      expect_op(")");
      return rel;
    }
    if (at_kw({"PREDICT"})) {
      ++i_;
      expect_op("(");
      expect_kw({"MODEL"});
      std::string model = jstrarr(compound_identifier());
      expect_op(",");
      std::string q = parse_query();
      expect_op(")");
      std::string alias, cols;
      parse_alias(alias, cols);
      return R"({"t":"PredictRelation","model":)" + model + ",\"query\":" + q +
             ",\"alias\":" + alias + ",\"pos\":" + pos + "}";
    }
    std::string parts = jstrarr(compound_identifier());
    std::string sample = "null";
    if (at_kw({"TABLESAMPLE"})) {
      ++i_;
      std::string method = expect_kw({"SYSTEM", "BERNOULLI"});
      expect_op("(");
      const Token& pct = cur();
      if (pct.kind != Tk::NUMBER) error("Expected sample percentage");
      ++i_;
      expect_op(")");
      std::string seed = "null";
      if (!eat_kw({"REPEATABLE"}).empty()) {
        expect_op("(");
        seed = cur().text;  // integer token
        ++i_;
        expect_op(")");
      }
      // pct serialized as float (python: float(text))
      std::string p = jnum(pct.text);
      if (!number_is_float(pct.text)) p += ".0";
      sample = "[" + jstr(method) + "," + p + "," + seed + "]";
    }
    std::string alias, cols;
    parse_alias(alias, cols);
    return R"({"t":"TableRef","parts":)" + parts + ",\"alias\":" + alias +
           ",\"column_aliases\":" + cols + ",\"sample\":" + sample +
           ",\"pos\":" + pos + "}";
  }

  void parse_alias(std::string& alias, std::string& cols) {
    alias = "null";
    cols = "null";
    if (!eat_kw({"AS"}).empty()) {
      alias = jstr(any_identifier());
    } else if (cur().kind == Tk::QIDENT ||
               (cur().kind == Tk::IDENT && !kReserved.count(cur().upper))) {
      alias = jstr(cur().text);
      ++i_;
    }
    if (alias != "null" && at_op({"("})) {
      expect_op("(");
      std::vector<std::string> cs{identifier()};
      while (eat_op(",")) cs.push_back(identifier());
      expect_op(")");
      cols = jstrarr(cs);
    }
  }

  // ------------------------------------------------------------ expressions
  std::string call2(const std::string& op, const std::string& a,
                    const std::string& b, const std::string& pos) {
    return R"({"t":"Call","op":)" + jstr(op) + ",\"args\":[" + a + "," + b +
           R"(],"distinct":false,"filter":null,"over":null,"pos":)" + pos + "}";
  }
  std::string call1(const std::string& op, const std::string& a,
                    const std::string& pos) {
    return R"({"t":"Call","op":)" + jstr(op) + ",\"args\":[" + a +
           R"(],"distinct":false,"filter":null,"over":null,"pos":)" + pos + "}";
  }
  std::string calln(const std::string& op, const std::vector<std::string>& args,
                    const std::string& pos) {
    return R"({"t":"Call","op":)" + jstr(op) + ",\"args\":" + jarr(args) +
           R"(,"distinct":false,"filter":null,"over":null,"pos":)" + pos + "}";
  }
  std::string lit_sym(const std::string& v) {
    return R"({"t":"Literal","value":)" + jstr(v) + R"(,"type_name":"SYMBOL","pos":[0,0]})";
  }

  std::string parse_expr() { return parse_or(); }

  std::string parse_or() {
    std::string left = parse_and();
    while (at_kw({"OR"})) {
      std::string pos = pos_here();
      ++i_;
      left = call2("OR", left, parse_and(), pos);
    }
    return left;
  }

  std::string parse_and() {
    std::string left = parse_not();
    while (at_kw({"AND"})) {
      std::string pos = pos_here();
      ++i_;
      left = call2("AND", left, parse_not(), pos);
    }
    return left;
  }

  std::string parse_not() {
    if (at_kw({"NOT"})) {
      std::string pos = pos_here();
      ++i_;
      return call1("NOT", parse_not(), pos);
    }
    return parse_predicate();
  }

  std::string parse_predicate() {
    std::string left = parse_additive_chain();
    for (;;) {
      std::string pos = pos_here();
      bool negated = false;
      size_t save = i_;
      if (at_kw({"NOT"})) {
        ++i_;
        negated = true;
      }
      const char* neg = negated ? "true" : "false";
      if (at_kw({"BETWEEN"})) {
        ++i_;
        eat_kw({"ASYMMETRIC"});
        bool sym = !eat_kw({"SYMMETRIC"}).empty();
        std::string low = parse_additive_chain();
        expect_kw({"AND"});
        std::string high = parse_additive_chain();
        left = R"({"t":"Between","expr":)" + left + ",\"low\":" + low +
               ",\"high\":" + high + ",\"negated\":" + neg +
               ",\"symmetric\":" + (sym ? "true" : "false") + ",\"pos\":" + pos + "}";
        continue;
      }
      if (at_kw({"IN"})) {
        ++i_;
        expect_op("(");
        if (at_kw({"SELECT", "WITH", "VALUES"})) {
          std::string q = parse_query();
          expect_op(")");
          left = R"({"t":"Subquery","query":)" + q +
                 R"(,"kind":"in","outer":)" + left + ",\"op\":null,\"negated\":" +
                 neg + ",\"pos\":" + pos + "}";
        } else {
          std::vector<std::string> vals{parse_expr()};
          while (eat_op(",")) vals.push_back(parse_expr());
          expect_op(")");
          left = R"({"t":"InList","expr":)" + left + ",\"values\":" + jarr(vals) +
                 ",\"negated\":" + neg + ",\"pos\":" + pos + "}";
        }
        continue;
      }
      if (at_kw({"LIKE", "ILIKE"})) {
        std::string kind = cur().upper;
        ++i_;
        std::string pattern = parse_additive_chain();
        std::string escape = "null";
        if (!eat_kw({"ESCAPE"}).empty()) escape = parse_additive_chain();
        left = R"({"t":"Like","expr":)" + left + ",\"pattern\":" + pattern +
               ",\"escape\":" + escape + ",\"negated\":" + neg +
               ",\"kind\":" + jstr(kind) + ",\"pos\":" + pos + "}";
        continue;
      }
      if (at_kw({"SIMILAR"})) {
        ++i_;
        expect_kw({"TO"});
        std::string pattern = parse_additive_chain();
        std::string escape = "null";
        if (!eat_kw({"ESCAPE"}).empty()) escape = parse_additive_chain();
        left = R"({"t":"Like","expr":)" + left + ",\"pattern\":" + pattern +
               ",\"escape\":" + escape + ",\"negated\":" + neg +
               R"(,"kind":"SIMILAR","pos":)" + pos + "}";
        continue;
      }
      if (negated) {
        i_ = save;
        return left;
      }
      if (at_kw({"IS"})) {
        ++i_;
        bool n2 = !eat_kw({"NOT"}).empty();
        const char* neg2 = n2 ? "true" : "false";
        if (!eat_kw({"NULL"}).empty()) {
          left = R"({"t":"IsNull","expr":)" + left + ",\"negated\":" + neg2 +
                 ",\"pos\":" + pos + "}";
        } else if (!eat_kw({"TRUE"}).empty()) {
          left = R"({"t":"IsBool","expr":)" + left + ",\"value\":true,\"negated\":" +
                 neg2 + ",\"pos\":" + pos + "}";
        } else if (!eat_kw({"FALSE"}).empty()) {
          left = R"({"t":"IsBool","expr":)" + left + ",\"value\":false,\"negated\":" +
                 neg2 + ",\"pos\":" + pos + "}";
        } else if (!eat_kw({"UNKNOWN"}).empty()) {
          left = R"({"t":"IsNull","expr":)" + left + ",\"negated\":" + neg2 +
                 ",\"pos\":" + pos + "}";
        } else if (!eat_kw({"DISTINCT"}).empty()) {
          expect_kw({"FROM"});
          std::string right = parse_additive_chain();
          left = R"({"t":"IsDistinctFrom","left":)" + left + ",\"right\":" + right +
                 ",\"negated\":" + neg2 + ",\"pos\":" + pos + "}";
        } else {
          error("Expected NULL/TRUE/FALSE/DISTINCT after IS");
        }
        continue;
      }
      if (cur().kind == Tk::OP && kComparisons.count(cur().text)) {
        std::string op = cur().text;
        if (op == "!=") op = "<>";
        ++i_;
        if (at_kw({"ANY", "SOME", "ALL"})) {
          std::string quant = cur().upper;
          ++i_;
          expect_op("(");
          std::string q = parse_query();
          expect_op(")");
          left = R"({"t":"Subquery","query":)" + q + ",\"kind\":" +
                 jstr(quant == "ALL" ? "all" : "any") + ",\"outer\":" + left +
                 ",\"op\":" + jstr(op) + ",\"negated\":false,\"pos\":" + pos + "}";
        } else {
          left = call2(op, left, parse_additive_chain(), pos);
        }
        continue;
      }
      return left;
    }
  }

  std::string parse_additive_chain() { return parse_concat(); }

  std::string parse_concat() {
    std::string left = parse_add();
    while (at_op({"||"})) {
      std::string pos = pos_here();
      ++i_;
      left = call2("||", left, parse_add(), pos);
    }
    return left;
  }

  std::string parse_add() {
    std::string left = parse_mul();
    while (at_op({"+", "-"})) {
      std::string pos = pos_here();
      std::string op = cur().text;
      ++i_;
      left = call2(op, left, parse_mul(), pos);
    }
    return left;
  }

  std::string parse_mul() {
    std::string left = parse_unary();
    while (at_op({"*", "/", "%"})) {
      std::string pos = pos_here();
      std::string op = cur().text;
      ++i_;
      left = call2(op, left, parse_unary(), pos);
    }
    return left;
  }

  std::string parse_unary() {
    std::string pos = pos_here();
    if (eat_op("-")) return call1("NEGATE", parse_unary(), pos);
    if (eat_op("+")) return parse_unary();
    return parse_postfix();
  }

  std::string parse_postfix() {
    std::string e = parse_primary();
    while (at_op({"::"})) {
      std::string pos = pos_here();
      ++i_;
      std::string tn, prec, scale;
      parse_type_name(tn, prec, scale);
      e = R"({"t":"Cast","expr":)" + e + ",\"type_name\":" + jstr(tn) +
          ",\"precision\":" + prec + ",\"scale\":" + scale + ",\"pos\":" + pos + "}";
    }
    return e;
  }

  void parse_type_name(std::string& name, std::string& prec, std::string& scale) {
    std::string raw = any_identifier();
    name.clear();
    for (char c : raw) name += (c >= 'a' && c <= 'z') ? char(c - 32) : c;
    if (name == "DOUBLE" && at_kw({"PRECISION"})) ++i_;
    prec = "null";
    scale = "null";
    if (at_op({"("})) {
      ++i_;
      prec = type_param();
      if (eat_op(",")) scale = type_param();
      expect_op(")");
    }
  }

  std::string type_param() {
    if (cur().kind != Tk::NUMBER ||
        cur().text.find_first_not_of("0123456789") != std::string::npos)
      error("Expected an integer type parameter");
    std::string v = cur().text;
    ++i_;
    return v;
  }

  std::string parse_primary() {
    const Token& t = cur();
    std::string pos = pos_of(t);

    if (t.kind == Tk::NUMBER) {
      ++i_;
      const char* tn = number_is_float(t.text) ? "DOUBLE" : "BIGINT";
      return R"({"t":"Literal","value":)" + jnum(t.text) + ",\"type_name\":" +
             jstr(tn) + ",\"pos\":" + pos + "}";
    }
    if (t.kind == Tk::STRING) {
      ++i_;
      return R"({"t":"Literal","value":)" + jstr(t.text) +
             R"(,"type_name":"VARCHAR","pos":)" + pos + "}";
    }
    if (at_op({"?"})) {
      ++i_;
      return R"({"t":"Param","index":)" + std::to_string(param_seq_++) +
             ",\"pos\":" + pos + "}";
    }
    if (at_op({"("})) {
      ++i_;
      if (at_kw({"SELECT", "WITH", "VALUES"})) {
        std::string q = parse_query();
        expect_op(")");
        return R"({"t":"Subquery","query":)" + q +
               R"(,"kind":"scalar","outer":null,"op":null,"negated":false,"pos":)" +
               pos + "}";
      }
      std::string e = parse_expr();
      if (at_op({","})) {
        std::vector<std::string> items{e};
        while (eat_op(",")) items.push_back(parse_expr());
        expect_op(")");
        return calln("ROW", items, pos);
      }
      expect_op(")");
      return e;
    }

    if (t.kind == Tk::QIDENT) return parse_identifier_expr();
    if (t.kind != Tk::IDENT) error("Expected expression");

    const std::string& u = t.upper;
    if (u == "CASE") return parse_case();
    if (u == "CAST" || u == "TRY_CAST") {
      ++i_;
      expect_op("(");
      std::string e = parse_expr();
      expect_kw({"AS"});
      std::string tn, prec, scale;
      parse_type_name(tn, prec, scale);
      expect_op(")");
      return R"({"t":"Cast","expr":)" + e + ",\"type_name\":" + jstr(tn) +
             ",\"precision\":" + prec + ",\"scale\":" + scale + ",\"pos\":" + pos + "}";
    }
    if (u == "EXISTS") {
      ++i_;
      expect_op("(");
      std::string q = parse_query();
      expect_op(")");
      return R"({"t":"Subquery","query":)" + q +
             R"(,"kind":"exists","outer":null,"op":null,"negated":false,"pos":)" +
             pos + "}";
    }
    if (u == "NOT") {
      ++i_;
      return call1("NOT", parse_not(), pos);
    }
    if (u == "TRUE") {
      ++i_;
      return R"({"t":"Literal","value":true,"type_name":"BOOLEAN","pos":)" + pos + "}";
    }
    if (u == "FALSE") {
      ++i_;
      return R"({"t":"Literal","value":false,"type_name":"BOOLEAN","pos":)" + pos + "}";
    }
    if (u == "NULL") {
      ++i_;
      return R"({"t":"Literal","value":null,"type_name":"NULL","pos":)" + pos + "}";
    }
    if (u == "INTERVAL") return parse_interval();
    if ((u == "DATE" || u == "TIME" || u == "TIMESTAMP") &&
        peek(1).kind == Tk::STRING) {
      ++i_;
      std::string s = cur().text;
      ++i_;
      return R"({"t":"Literal","value":)" + jstr(s) + ",\"type_name\":" + jstr(u) +
             ",\"pos\":" + pos + "}";
    }
    if (u == "EXTRACT" && at_op({"("}, 1)) {
      i_ += 2;
      std::string field = any_identifier();
      for (auto& c : field)
        if (c >= 'a' && c <= 'z') c -= 32;
      expect_kw({"FROM"});
      std::string e = parse_expr();
      expect_op(")");
      return calln("EXTRACT", {lit_sym(field), e}, pos);
    }
    if (u == "SUBSTRING" && at_op({"("}, 1)) {
      i_ += 2;
      std::string e = parse_expr();
      std::string start, length = "";
      if (!eat_kw({"FROM"}).empty()) {
        start = parse_expr();
        if (!eat_kw({"FOR"}).empty()) length = parse_expr();
      } else {
        expect_op(",");
        start = parse_expr();
        if (eat_op(",")) length = parse_expr();
      }
      expect_op(")");
      std::vector<std::string> args{e, start};
      if (!length.empty()) args.push_back(length);
      return calln("SUBSTRING", args, pos);
    }
    if (u == "TRIM" && at_op({"("}, 1)) {
      i_ += 2;
      std::string side = "BOTH";
      if (at_kw({"BOTH", "LEADING", "TRAILING"})) {
        side = cur().upper;
        ++i_;
      }
      std::string chars = "";
      if (!at_kw({"FROM"})) chars = parse_expr();
      std::string e;
      if (!eat_kw({"FROM"}).empty()) {
        e = parse_expr();
      } else {
        e = chars;  // TRIM(x) form
        chars = "";
      }
      expect_op(")");
      std::string chars_arg =
          !chars.empty()
              ? chars
              : R"({"t":"Literal","value":" ","type_name":"VARCHAR","pos":[0,0]})";
      return calln("TRIM", {lit_sym(side), chars_arg, e}, pos);
    }
    if (u == "POSITION" && at_op({"("}, 1)) {
      i_ += 2;
      std::string needle = parse_additive_chain();
      expect_kw({"IN"});
      std::string hay = parse_expr();
      expect_op(")");
      return calln("POSITION", {needle, hay}, pos);
    }
    if (u == "OVERLAY" && at_op({"("}, 1)) {
      i_ += 2;
      std::string e = parse_expr();
      expect_kw({"PLACING"});
      std::string repl = parse_expr();
      expect_kw({"FROM"});
      std::string start = parse_expr();
      std::string length = "";
      if (!eat_kw({"FOR"}).empty()) length = parse_expr();
      expect_op(")");
      std::vector<std::string> args{e, repl, start};
      if (!length.empty()) args.push_back(length);
      return calln("OVERLAY", args, pos);
    }
    if ((u == "CEIL" || u == "CEILING" || u == "FLOOR") && at_op({"("}, 1)) {
      i_ += 2;
      std::string e = parse_expr();
      std::string op = (u == "FLOOR") ? "FLOOR" : "CEIL";
      if (!eat_kw({"TO"}).empty()) {
        std::string unit = any_identifier();
        for (auto& c : unit)
          if (c >= 'a' && c <= 'z') c -= 32;
        expect_op(")");
        return calln(op, {e, lit_sym(unit)}, pos);
      }
      expect_op(")");
      return calln(op, {e}, pos);
    }
    if ((u == "CURRENT_DATE" || u == "CURRENT_TIMESTAMP" || u == "CURRENT_TIME" ||
         u == "LOCALTIME" || u == "LOCALTIMESTAMP") &&
        !at_op({"("}, 1)) {
      ++i_;
      return calln(u, {}, pos);
    }
    if (u == "ROW" && at_op({"("}, 1)) {
      i_ += 2;
      std::vector<std::string> items{parse_expr()};
      while (eat_op(",")) items.push_back(parse_expr());
      expect_op(")");
      return calln("ROW", items, pos);
    }
    return parse_identifier_expr();
  }

  std::string parse_identifier_expr() {
    std::string pos = pos_here();
    Token first = cur();
    if (first.kind == Tk::IDENT && kReserved.count(first.upper) &&
        first.upper != "LEFT" && first.upper != "RIGHT")
      error("Expected expression");
    std::string name = any_identifier();
    if (at_op({"("}) && first.kind == Tk::IDENT) return parse_call(name, pos);
    std::vector<std::string> parts{name};
    while (at_op({"."})) {
      if (at_op({"*"}, 1)) {
        i_ += 2;
        return R"({"t":"Star","table":)" + jstr(parts.back()) + ",\"pos\":" + pos + "}";
      }
      ++i_;
      parts.push_back(any_identifier());
    }
    return R"({"t":"ColumnRef","parts":)" + jstrarr(parts) + ",\"pos\":" + pos + "}";
  }

  std::string parse_call(const std::string& name, const std::string& pos) {
    expect_op("(");
    bool distinct = false;
    std::vector<std::string> args;
    if (at_op({"*"}) && peek(1).kind == Tk::OP && peek(1).text == ")") {
      ++i_;
      args.push_back(R"({"t":"Star","table":null,"pos":[0,0]})");
    } else if (!at_op({")"})) {
      if (!eat_kw({"DISTINCT"}).empty())
        distinct = true;
      else
        eat_kw({"ALL"});
      args.push_back(parse_expr());
      while (eat_op(",")) args.push_back(parse_expr());
    }
    expect_op(")");
    std::string upper = name;
    for (auto& c : upper)
      if (c >= 'a' && c <= 'z') c -= 32;
    std::string filter = "null";
    if (!eat_kw({"FILTER"}).empty()) {
      expect_op("(");
      expect_kw({"WHERE"});
      filter = parse_expr();
      expect_op(")");
    }
    if (!eat_kw({"WITHIN"}).empty()) {
      // WITHIN GROUP (ORDER BY ...) — parsed and discarded, like the python
      // parser (sort keys unsupported downstream)
      expect_kw({"GROUP"});
      expect_op("(");
      expect_kw({"ORDER"});
      expect_kw({"BY"});
      parse_sort_key();
      while (eat_op(",")) parse_sort_key();
      expect_op(")");
    }
    std::string over = "null";
    if (!eat_kw({"OVER"}).empty()) over = parse_window_spec();
    // "orig" keeps the source-case function name for case-sensitive UDF lookup
    return R"({"t":"Call","op":)" + jstr(upper) + ",\"args\":" + jarr(args) +
           ",\"distinct\":" + (distinct ? "true" : "false") +
           ",\"filter\":" + filter + ",\"over\":" + over +
           ",\"orig\":" + jstr(name) + ",\"pos\":" + pos + "}";
  }

  std::string parse_window_spec() {
    expect_op("(");
    std::vector<std::string> partition_by, order_by;
    std::string frame = "null";
    if (!eat_kw({"PARTITION"}).empty()) {
      expect_kw({"BY"});
      partition_by.push_back(parse_expr());
      while (eat_op(",")) partition_by.push_back(parse_expr());
    }
    if (at_kw({"ORDER"})) {
      ++i_;
      expect_kw({"BY"});
      order_by.push_back(parse_sort_key());
      while (eat_op(",")) order_by.push_back(parse_sort_key());
    }
    if (at_kw({"ROWS", "RANGE"})) {
      std::string kind = cur().upper;
      ++i_;
      std::string lo, hi;
      if (!eat_kw({"BETWEEN"}).empty()) {
        lo = parse_frame_bound();
        expect_kw({"AND"});
        hi = parse_frame_bound();
      } else {
        lo = parse_frame_bound();
        hi = R"(["CURRENT",null])";
      }
      frame = "[" + jstr(kind) + "," + lo + "," + hi + "]";
    }
    expect_op(")");
    return R"({"t":"WindowSpec","partition_by":)" + jarr(partition_by) +
           ",\"order_by\":" + jarr(order_by) + ",\"frame\":" + frame + "}";
  }

  std::string parse_frame_bound() {
    if (!eat_kw({"UNBOUNDED"}).empty()) {
      std::string which = expect_kw({"PRECEDING", "FOLLOWING"});
      return "[\"UNBOUNDED_" + which + "\",null]";
    }
    if (!eat_kw({"CURRENT"}).empty()) {
      expect_kw({"ROW"});
      return R"(["CURRENT",null])";
    }
    const Token& t = cur();
    if (t.kind != Tk::NUMBER) error("Expected frame bound");
    ++i_;
    std::string n = t.text;
    std::string which = expect_kw({"PRECEDING", "FOLLOWING"});
    return "[" + jstr(which) + "," + n + "]";
  }

  std::string parse_case() {
    std::string pos = pos_here();
    expect_kw({"CASE"});
    std::string operand = "null";
    if (!at_kw({"WHEN"})) operand = parse_expr();
    std::vector<std::string> whens;
    while (!eat_kw({"WHEN"}).empty()) {
      std::string cond = parse_expr();
      expect_kw({"THEN"});
      std::string val = parse_expr();
      whens.push_back("[" + cond + "," + val + "]");
    }
    std::string else_ = "null";
    if (!eat_kw({"ELSE"}).empty()) else_ = parse_expr();
    expect_kw({"END"});
    return R"({"t":"Case","operand":)" + operand + ",\"whens\":" + jarr(whens) +
           ",\"else_\":" + else_ + ",\"pos\":" + pos + "}";
  }

  std::string parse_interval() {
    std::string pos = pos_here();
    expect_kw({"INTERVAL"});
    int sign = 1;
    if (eat_op("-")) sign = -1;
    const Token& t = cur();
    std::string value;        // JSON-encoded
    bool numeric = false;     // value is a JSON number
    std::string raw_text;     // original text for string values
    if (t.kind == Tk::STRING) {
      ++i_;
      raw_text = t.text;
    } else if (t.kind == Tk::NUMBER) {
      ++i_;
      value = jnum(t.text);
      numeric = true;
    } else {
      error("Expected interval value");
    }
    std::string unit = any_identifier();
    for (auto& c : unit)
      if (c >= 'a' && c <= 'z') c -= 32;
    while (!unit.empty() && unit.back() == 'S') unit.pop_back();  // DAYS -> DAY
    std::string to_unit = "null";
    if (!eat_kw({"TO"}).empty()) {
      std::string tu = any_identifier();
      for (auto& c : tu)
        if (c >= 'a' && c <= 'z') c -= 32;
      while (!tu.empty() && tu.back() == 'S') tu.pop_back();
      to_unit = jstr(tu);
    }
    if (!numeric) {
      // string values: try int, then float, else keep the raw string
      // (compound forms like '1-2' are handled by the binder)
      char* end = nullptr;
      const char* s = raw_text.c_str();
      long long iv = std::strtoll(s, &end, 10);
      if (end && *end == '\0' && end != s) {
        value = std::to_string(iv);
        numeric = true;
      } else {
        double dv = std::strtod(s, &end);
        if (end && *end == '\0' && end != s) {
          if (std::isnan(dv)) {
            value = "NaN";  // Python's json.loads accepts NaN/Infinity
          } else if (std::isinf(dv)) {
            value = dv > 0 ? "Infinity" : "-Infinity";
          } else {
            std::ostringstream os;
            os.precision(17);
            os << dv;
            value = os.str();
            if (value.find('.') == std::string::npos &&
                value.find('e') == std::string::npos)
              value += ".0";
          }
          numeric = true;
        } else {
          value = jstr(raw_text);
        }
      }
    }
    if (numeric && sign < 0) value = "-" + value;
    return R"({"t":"IntervalLiteral","value":)" + value + ",\"unit\":" + jstr(unit) +
           ",\"to_unit\":" + to_unit + ",\"pos\":" + pos + "}";
  }
};

}  // namespace

std::string parse_statements_json(const std::string& sql) {
  Parser p(sql);
  return p.parse_statements();
}

}  // namespace dsql
