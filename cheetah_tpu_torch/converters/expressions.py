"""Arithmetic expression evaluators for lattice files (a copy of
``cheetah_tpu/converters/expressions.py``, which is plain Python).

Equivalent coverage to the reference's ``converters/utils/infix.py`` and
``converters/utils/rpn.py``, implemented differently: the infix evaluator is a
Pratt (precedence-climbing) parser rather than a shunting-yard/AST pipeline,
and the RPN evaluator is table-driven.
"""

from __future__ import annotations

import math
import re
from typing import Any

_UNARY_FUNCTIONS = {
    "sqrt": math.sqrt,
    "sin": math.sin,
    "asin": math.asin,
    "cos": math.cos,
    "acos": math.acos,
    "tan": math.tan,
    "atan": math.atan,
    "abs": abs,
    "log": math.log,
}

_BINARY_OPERATORS = {
    "+": (1, lambda a, b: a + b),
    "-": (1, lambda a, b: a - b),
    "*": (2, lambda a, b: a * b),
    "/": (2, lambda a, b: a / b),
    "^": (3, lambda a, b: a**b),
}


def _tokenize(expression: str, context: dict) -> list:
    """Split an infix expression into numbers, names (resolved from context),
    function names and operator characters. Supports ``var[key]`` lookups."""
    tokens: list = []
    i = 0
    n = len(expression)
    while i < n:
        char = expression[i]
        if char.isspace():
            i += 1
        elif char in "+-*/^()":
            tokens.append(char)
            i += 1
        else:
            j = i
            while j < n and (expression[j] not in "+-*/^()[] \t"):
                j += 1
            word = expression[i:j]
            if j < n and expression[j] == "[":
                # var[key] lookup
                end = expression.index("]", j)
                key = expression[j + 1 : end]
                if word not in context or key not in context[word]:
                    raise SyntaxError(f"Unknown lookup {word}[{key}]")
                tokens.append(context[word][key])
                j = end + 1
            elif word in _UNARY_FUNCTIONS and j < n and expression[j] == "(":
                tokens.append(word)
            elif word in context:
                value = context[word]
                if callable(value):
                    tokens.append(word if word in _UNARY_FUNCTIONS else value)
                else:
                    tokens.append(value)
            else:
                try:
                    tokens.append(float(word))
                except ValueError:
                    raise SyntaxError(f"Unknown token {word!r}")
            i = j
    return tokens


class _Parser:
    """Pratt parser over the token stream."""

    def __init__(self, tokens: list):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self):
        token = self.peek()
        self.pos += 1
        return token

    def parse_expression(self, min_precedence: int = 0) -> Any:
        left = self.parse_atom()
        while True:
            token = self.peek()
            if not isinstance(token, str) or token not in _BINARY_OPERATORS:
                break
            precedence, fn = _BINARY_OPERATORS[token]
            if precedence < min_precedence:
                break
            self.next()
            right = self.parse_expression(precedence + 1)
            left = fn(left, right)
        return left

    def parse_atom(self) -> Any:
        token = self.next()
        if token is None:
            raise SyntaxError("Unexpected end of expression")
        if isinstance(token, str):
            if token == "(":
                value = self.parse_expression()
                if self.next() != ")":
                    raise SyntaxError("Mismatched parentheses in expression")
                return value
            if token == "-":
                return -self.parse_expression(3)
            if token == "+":
                return self.parse_expression(3)
            if token in _UNARY_FUNCTIONS:
                if self.next() != "(":
                    raise SyntaxError(f"Expected '(' after function {token}")
                argument = self.parse_expression()
                if self.next() != ")":
                    raise SyntaxError("Mismatched parentheses in expression")
                return _UNARY_FUNCTIONS[token](argument)
            raise SyntaxError(f"Unexpected token {token!r}")
        return token


def evaluate_infix(expression: str, context: dict | None = None) -> Any:
    """Evaluate an infix-notation expression; raises ``SyntaxError`` if
    invalid."""
    context = context or {}
    try:
        parser = _Parser(_tokenize(expression, context))
        result = parser.parse_expression()
    except (IndexError, ValueError, TypeError, KeyError, SyntaxError) as e:
        raise SyntaxError(f"Invalid expression: {expression}. {e}")
    if parser.pos != len(parser.tokens):
        raise SyntaxError(f"Invalid expression: {expression}. Trailing tokens.")
    return result


def evaluate_rpn(expression: str, context: dict | None = None) -> Any:
    """Evaluate a Reverse-Polish-Notation expression (Elegant ``.lte`` style);
    raises ``SyntaxError`` if invalid."""
    context = context or {}
    stack: list = []

    def pop(n: int, token: str) -> list:
        if len(stack) < n:
            raise SyntaxError(
                f"Invalid expression: {expression} - Need {n} value(s) before {token}"
            )
        values = stack[-n:]
        del stack[-n:]
        return values

    for token in filter(None, re.split(r"(\+|\-|\*|/|\^)|\s", expression.strip())):
        if token in _BINARY_OPERATORS:
            a, b = pop(2, token)
            stack.append(_BINARY_OPERATORS[token][1](a, b))
        elif token in _UNARY_FUNCTIONS:
            (a,) = pop(1, token)
            stack.append(_UNARY_FUNCTIONS[token](a))
        elif token.startswith("#"):
            break  # Comment: ignore the rest of the expression
        else:
            try:
                stack.append(float(token))
            except ValueError:
                if token in context:
                    stack.append(context[token])
                elif "[" in token and token.endswith("]"):
                    var, key = token[:-1].split("[", 1)
                    if var in context and key in context[var]:
                        stack.append(context[var][key])
                    else:
                        raise SyntaxError(
                            f"Invalid expression: {expression} - {token} is not a "
                            "number or a variable"
                        )
                else:
                    raise SyntaxError(
                        f"Invalid expression: {expression} - {token} is not a "
                        "number or a variable"
                    )
    if len(stack) != 1:
        raise SyntaxError(
            f"Invalid RPN expression: {expression} - Stack not empty after evaluation"
        )
    return stack[0]
