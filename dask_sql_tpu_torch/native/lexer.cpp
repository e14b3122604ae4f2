#include "lexer.h"

#include <cctype>

namespace dsql {

namespace {

const char* kMultiOps[] = {"<>", "!=", ">=", "<=", "||", "::", "=>"};
const std::string kSingleOps = "+-*/%=<>(),.;[]{}?&^|~:";

inline bool is_ident_start(unsigned char c) {
  return std::isalpha(c) || c == '_' || c >= 0x80;  // utf-8 continuation ok
}
inline bool is_ident_char(unsigned char c) {
  return std::isalnum(c) || c == '_' || c == '$' || c >= 0x80;
}

std::string ascii_upper(const std::string& s) {
  std::string out = s;
  for (auto& c : out)
    if (c >= 'a' && c <= 'z') c -= 32;
  return out;
}

}  // namespace

std::vector<Token> tokenize(const std::string& sql) {
  std::vector<Token> tokens;
  size_t i = 0, n = sql.size();
  int line = 1, col = 1;

  auto advance = [&](size_t k) {
    for (size_t j = 0; j < k; ++j) {
      if (i < n && sql[i] == '\n') {
        ++line;
        col = 1;
      } else {
        ++col;
      }
      ++i;
    }
  };
  auto push = [&](Tk kind, std::string text, int l, int c) {
    Token t;
    t.kind = kind;
    t.upper = (kind == Tk::IDENT) ? ascii_upper(text) : "";
    t.text = std::move(text);
    t.line = l;
    t.col = c;
    tokens.push_back(std::move(t));
  };

  while (i < n) {
    char c = sql[i];
    if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
      advance(1);
      continue;
    }
    if (c == '-' && i + 1 < n && sql[i + 1] == '-') {  // line comment
      while (i < n && sql[i] != '\n') advance(1);
      continue;
    }
    if (c == '/' && i + 1 < n && sql[i + 1] == '*') {  // block comment
      int sl = line, sc = col;
      advance(2);
      while (i < n && !(sql[i] == '*' && i + 1 < n && sql[i + 1] == '/')) advance(1);
      if (i >= n) throw LexError{"Unterminated block comment", sl, sc};
      advance(2);
      continue;
    }
    if (c == '\'') {  // string literal, '' escapes
      int sl = line, sc = col;
      advance(1);
      std::string buf;
      for (;;) {
        if (i >= n) throw LexError{"Unterminated string literal", sl, sc};
        if (sql[i] == '\'') {
          if (i + 1 < n && sql[i + 1] == '\'') {
            buf += '\'';
            advance(2);
            continue;
          }
          advance(1);
          break;
        }
        buf += sql[i];
        advance(1);
      }
      push(Tk::STRING, buf, sl, sc);
      continue;
    }
    if (c == '"' || c == '`') {  // quoted identifier
      char quote = c;
      int sl = line, sc = col;
      advance(1);
      std::string buf;
      for (;;) {
        if (i >= n) throw LexError{"Unterminated quoted identifier", sl, sc};
        if (sql[i] == quote) {
          if (i + 1 < n && sql[i + 1] == quote) {
            buf += quote;
            advance(2);
            continue;
          }
          advance(1);
          break;
        }
        buf += sql[i];
        advance(1);
      }
      push(Tk::QIDENT, buf, sl, sc);
      continue;
    }
    if (std::isdigit((unsigned char)c) ||
        (c == '.' && i + 1 < n && std::isdigit((unsigned char)sql[i + 1]))) {
      int sl = line, sc = col;
      size_t j = i;
      bool seen_dot = false, seen_exp = false;
      while (j < n) {
        char ch = sql[j];
        if (std::isdigit((unsigned char)ch)) {
          ++j;
        } else if (ch == '.' && !seen_dot && !seen_exp) {
          seen_dot = true;
          ++j;
        } else if ((ch == 'e' || ch == 'E') && !seen_exp && j + 1 < n &&
                   (std::isdigit((unsigned char)sql[j + 1]) ||
                    ((sql[j + 1] == '+' || sql[j + 1] == '-') && j + 2 < n &&
                     std::isdigit((unsigned char)sql[j + 2])))) {
          seen_exp = true;
          j += (sql[j + 1] == '+' || sql[j + 1] == '-') ? 2 : 1;
        } else {
          break;
        }
      }
      std::string text = sql.substr(i, j - i);
      advance(j - i);
      push(Tk::NUMBER, text, sl, sc);
      continue;
    }
    if (is_ident_start((unsigned char)c)) {
      int sl = line, sc = col;
      size_t j = i;
      while (j < n && is_ident_char((unsigned char)sql[j])) ++j;
      std::string text = sql.substr(i, j - i);
      advance(j - i);
      push(Tk::IDENT, text, sl, sc);
      continue;
    }
    if (i + 1 < n) {
      std::string two = sql.substr(i, 2);
      bool matched = false;
      for (const char* op : kMultiOps) {
        if (two == op) {
          push(Tk::OP, two, line, col);
          advance(2);
          matched = true;
          break;
        }
      }
      if (matched) continue;
    }
    if (kSingleOps.find(c) != std::string::npos) {
      push(Tk::OP, std::string(1, c), line, col);
      advance(1);
      continue;
    }
    throw LexError{std::string("Unexpected character '") + c + "'", line, col};
  }
  push(Tk::END, "", line, col);
  return tokens;
}

}  // namespace dsql
