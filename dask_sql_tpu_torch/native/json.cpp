#include "json.h"

#include <cinttypes>
#include <cmath>
#include <cstdio>
#include <cstring>

#include "parser.h"  // json_quote

namespace dsql {

namespace {

struct P {
  const char* p;
  const char* end;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  [[noreturn]] void fail(const std::string& m) {
    throw JsonError("json: " + m);
  }
  char peek() {
    if (p >= end) fail("unexpected end");
    return *p;
  }
  void expect(char c) {
    if (p >= end || *p != c) fail(std::string("expected '") + c + "'");
    ++p;
  }
  bool lit(const char* s) {
    size_t n = std::strlen(s);
    if ((size_t)(end - p) >= n && std::memcmp(p, s, n) == 0) {
      p += n;
      return true;
    }
    return false;
  }

  std::string parse_string() {
    expect('"');
    std::string out;
    while (true) {
      if (p >= end) fail("unterminated string");
      char c = *p++;
      if (c == '"') break;
      if (c == '\\') {
        if (p >= end) fail("bad escape");
        char e = *p++;
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            if (end - p < 4) fail("bad \\u escape");
            unsigned v = 0;
            for (int k = 0; k < 4; ++k) {
              char h = *p++;
              v <<= 4;
              if (h >= '0' && h <= '9') v |= h - '0';
              else if (h >= 'a' && h <= 'f') v |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') v |= h - 'A' + 10;
              else fail("bad hex digit");
            }
            // encode code point (surrogate pairs for the BMP-external
            // range the Python bridge never emits; kept for completeness)
            unsigned cp = v;
            if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 &&
                p[0] == '\\' && p[1] == 'u') {
              unsigned lo = 0;
              const char* q = p + 2;
              bool ok = true;
              for (int k = 0; k < 4; ++k) {
                char h = q[k];
                lo <<= 4;
                if (h >= '0' && h <= '9') lo |= h - '0';
                else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
                else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
                else { ok = false; break; }
              }
              if (ok && lo >= 0xDC00 && lo <= 0xDFFF) {
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                p += 6;
              }
            }
            if (cp < 0x80) {
              out += (char)cp;
            } else if (cp < 0x800) {
              out += (char)(0xC0 | (cp >> 6));
              out += (char)(0x80 | (cp & 0x3F));
            } else if (cp < 0x10000) {
              out += (char)(0xE0 | (cp >> 12));
              out += (char)(0x80 | ((cp >> 6) & 0x3F));
              out += (char)(0x80 | (cp & 0x3F));
            } else {
              out += (char)(0xF0 | (cp >> 18));
              out += (char)(0x80 | ((cp >> 12) & 0x3F));
              out += (char)(0x80 | ((cp >> 6) & 0x3F));
              out += (char)(0x80 | (cp & 0x3F));
            }
            break;
          }
          default:
            fail("bad escape char");
        }
      } else {
        out += c;
      }
    }
    return out;
  }

  JVP parse_number() {
    const char* start = p;
    if (peek() == '-') ++p;
    while (p < end && *p >= '0' && *p <= '9') ++p;
    bool integral = true;
    if (p < end && *p == '.') {
      integral = false;
      ++p;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      integral = false;
      ++p;
      if (p < end && (*p == '+' || *p == '-')) ++p;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    std::string tok(start, p - start);
    if (integral) {
      errno = 0;
      char* endp = nullptr;
      long long v = std::strtoll(tok.c_str(), &endp, 10);
      if (errno == 0 && endp && *endp == '\0') return JV::integer(v);
      // out of int64 range: the Python bridge refuses such plans before
      // serializing, so this is parse-of-foreign-input safety only
      return JV::dbl(std::strtod(tok.c_str(), nullptr));
    }
    return JV::dbl(std::strtod(tok.c_str(), nullptr));
  }

  JVP value() {
    ws();
    char c = peek();
    if (c == '{') {
      ++p;
      auto o = JV::object();
      ws();
      if (peek() == '}') { ++p; return o; }
      while (true) {
        ws();
        std::string k = parse_string();
        ws();
        expect(':');
        o->set(k, value());
        ws();
        if (peek() == ',') { ++p; continue; }
        expect('}');
        return o;
      }
    }
    if (c == '[') {
      ++p;
      auto a = JV::array();
      ws();
      if (peek() == ']') { ++p; return a; }
      while (true) {
        a->push(value());
        ws();
        if (peek() == ',') { ++p; continue; }
        expect(']');
        return a;
      }
    }
    if (c == '"') return JV::str(parse_string());
    if (lit("null")) return JV::null();
    if (lit("true")) return JV::boolean(true);
    if (lit("false")) return JV::boolean(false);
    if (c == '-' || (c >= '0' && c <= '9')) return parse_number();
    fail("unexpected character");
  }
};

void emit(const JVP& v, std::string& out) {
  if (!v) { out += "null"; return; }
  switch (v->kind) {
    case JV::NUL: out += "null"; break;
    case JV::BOOL: out += v->b ? "true" : "false"; break;
    case JV::INT: {
      char buf[32];
      std::snprintf(buf, sizeof buf, "%" PRId64, v->i);
      out += buf;
      break;
    }
    case JV::DBL: {
      if (std::isnan(v->d)) { out += "\"__nan__\""; break; }
      if (std::isinf(v->d)) {
        out += v->d > 0 ? "\"__inf__\"" : "\"__-inf__\"";
        break;
      }
      char buf[40];
      std::snprintf(buf, sizeof buf, "%.17g", v->d);
      // ensure a float stays a float on re-parse
      if (!std::strpbrk(buf, ".eE")) std::strcat(buf, ".0");
      out += buf;
      break;
    }
    case JV::STR: out += json_quote(v->s); break;
    case JV::ARR: {
      out += '[';
      for (size_t k = 0; k < v->arr.size(); ++k) {
        if (k) out += ',';
        emit(v->arr[k], out);
      }
      out += ']';
      break;
    }
    case JV::OBJ: {
      out += '{';
      for (size_t k = 0; k < v->obj.size(); ++k) {
        if (k) out += ',';
        out += json_quote(v->obj[k].first);
        out += ':';
        emit(v->obj[k].second, out);
      }
      out += '}';
      break;
    }
  }
}

}  // namespace

JVP json_parse(const std::string& text) {
  P parser{text.c_str(), text.c_str() + text.size()};
  JVP v = parser.value();
  parser.ws();
  if (parser.p != parser.end) throw JsonError("json: trailing data");
  return v;
}

std::string json_emit(const JVP& v) {
  std::string out;
  emit(v, out);
  return out;
}

}  // namespace dsql
