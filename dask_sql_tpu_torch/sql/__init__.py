from .parser import parse_sql, parse_one  # noqa: F401
from .lexer import tokenize, Token, LexError  # noqa: F401
