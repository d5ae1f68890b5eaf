"""JWT field-parsing gadgets.

Native equivalents of the reference's jwt template family
(circuit/templates/helpers/jwt/*.circom): StringBodies (escaped-quote-aware
in-string map), brackets maps, whitespace checks, and the
ParseJWTField* structure validators (9-check shared logic +
quoted/unquoted/email_verified variants), plus EmailVerifiedCheck.

A jax-free copy of keyless_zk_tpu/circuits/jwt_gadget.py: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from .r1cs import ConstraintSystem, LinComb
from .gadgets import (
    array_selector,
    is_equal,
    is_zero,
    left_array_selector,
    less_than,
    right_array_selector,
    select_array_value,
    single_one_array,
)
from .hash_gadget import hash_bytes_to_field_with_len, is_substring


def b_and(cs, a: LinComb, b: LinComb) -> LinComb:
    return cs.lc(cs.mul(a, b))


def b_or(cs, a: LinComb, b: LinComb) -> LinComb:
    return a + b - b_and(cs, a, b)


def b_not(cs, a: LinComb) -> LinComb:
    return cs.const(1) - a


def multi_and(cs, bits: list[LinComb]) -> LinComb:
    while len(bits) > 1:
        bits = [
            b_and(cs, bits[i], bits[i + 1]) if i + 1 < len(bits) else bits[i]
            for i in range(0, len(bits), 2)
        ]
    return bits[0]


def is_whitespace(cs: ConstraintSystem, ch: LinComb) -> LinComb:
    """IsWhitespace.circom: ascii 9..13 or 32."""
    ge9 = b_not(cs, cs.lc(less_than(cs, ch, cs.const(9), 8)))
    le13 = cs.lc(less_than(cs, ch, cs.const(14), 8))
    line_break = b_and(cs, ge9, le13)
    space = cs.lc(is_equal(cs, ch, cs.const(32)))
    return line_break + space  # disjoint -> cheap OR


def string_bodies(cs: ConstraintSystem, chars: list[LinComb]) -> list[LinComb]:
    """StringBodies.circom:11-51: 1 inside (non-escaped) quoted bodies."""
    n = len(chars)
    quotes, quote_parity = [], []
    backslash_parity = []
    q0 = cs.lc(is_equal(cs, chars[0], cs.const(34)))
    quotes.append(q0)
    quote_parity.append(q0)
    backslash_parity.append(cs.lc(is_equal(cs, chars[0], cs.const(92))))
    for i in range(1, n):
        bs = cs.lc(is_equal(cs, chars[i], cs.const(92)))
        backslash_parity.append(b_and(cs, bs, b_not(cs, backslash_parity[i - 1])))
    for i in range(1, n):
        is_q = cs.lc(is_equal(cs, chars[i], cs.const(34)))
        q = b_and(cs, is_q, b_not(cs, backslash_parity[i - 1]))
        quotes.append(q)
        # XOR(q, prev)
        quote_parity.append(q + quote_parity[i - 1] - b_and(cs, q, quote_parity[i - 1]).scale(2))
    out = [LinComb()]
    for i in range(1, n):
        out.append(b_and(cs, quote_parity[i - 1], quote_parity[i]))
    return out


def brackets_map(cs: ConstraintSystem, chars: list[LinComb]) -> list[LinComb]:
    """BracketsMap.circom: +1 at '{', -1 at '}', 0 elsewhere."""
    out = []
    for ch in chars:
        op = cs.lc(is_equal(cs, ch, cs.const(123)))
        cl = cs.lc(is_equal(cs, ch, cs.const(125)))
        out.append(op - cl)
    return out


def brackets_depth_map(cs: ConstraintSystem, brackets: list[LinComb]) -> list[LinComb]:
    """BracketsDepthMap.circom:31-55 (nesting depth, outermost pair ignored)."""
    n = len(brackets)
    run = []
    acc = LinComb()
    for b in brackets:
        acc = acc + b
        run.append(acc)
    p2 = [r - cs.const(1) for r in run]
    p3 = []
    for v in p2:
        neg = cs.lc(less_than(cs, v, cs.const(0), 20))
        p3.append(cs.lc(cs.mul(v, b_not(cs, neg))))
    out = [LinComb()]
    for i in range(1, n):
        inc = cs.lc(is_equal(cs, p3[i], p3[i - 1] + cs.const(1)))
        out.append(p3[i] - inc)
    return out


def enforce_not_nested(
    cs: ConstraintSystem, start_index: LinComb, field_len: LinComb, depth_map: list[LinComb]
) -> None:
    """EnforceNotNested.circom: the field must not lie inside nested braces."""
    sel = array_selector(cs, start_index, start_index + field_len, len(depth_map))
    acc = LinComb()
    for s, d in zip(sel, depth_map):
        acc = acc + cs.lc(cs.mul(cs.lc(s), d))
    cs.constrain_zero(acc)


def array_selector_complex(
    cs: ConstraintSystem, start: LinComb, end: LinComb, length: int
) -> list[LinComb]:
    """ArraySelectorComplex.circom: out[i] = (start <= i < end), all-zero
    when end <= start; start must be nonzero."""
    cs.constrain_eq(cs.lc(is_zero(cs, start)), LinComb())
    right = right_array_selector(cs, start - cs.const(1), length)
    left = left_array_selector(cs, end, length)
    return [b_and(cs, cs.lc(r), cs.lc(l)) for r, l in zip(right, left)]


def parse_jwt_field_shared(
    cs: ConstraintSystem,
    field: list[LinComb],
    name: list[LinComb],
    value: list[LinComb],
    field_len: LinComb,
    name_len: LinComb,
    value_index: LinComb,
    value_len: LinComb,
    colon_index: LinComb,
    skip_checks: LinComb,
) -> None:
    """ParseJWTFieldSharedLogic.circom:26-70: '"'name'"' []':'[] value
    (','|'}') structure, with name/value substring proofs."""
    checks = []
    checks.append(cs.lc(less_than(cs, name_len, colon_index, 20)))
    checks.append(cs.lc(less_than(cs, colon_index, value_index, 20)))
    checks.append(
        cs.lc(less_than(cs, name_len + value_len, field_len, 20))
    )  # field_len > name_len + value_len
    field_hash = hash_bytes_to_field_with_len(cs, field, field_len)
    checks.append(cs.lc(is_equal(cs, field[0], cs.const(34))))
    checks.append(
        cs.lc(is_substring(cs, field, field_hash, name, name_len, cs.const(1)))
    )
    second_quote = select_array_value(cs, field, name_len + cs.const(1))
    checks.append(cs.lc(is_equal(cs, second_quote, cs.const(34))))
    colon = select_array_value(cs, field, colon_index)
    checks.append(cs.lc(is_equal(cs, colon, cs.const(58))))
    checks.append(
        cs.lc(is_substring(cs, field, field_hash, value, value_len, value_index))
    )
    last_char = select_array_value(cs, field, field_len - cs.const(1))
    prod = cs.mul(last_char - cs.const(44), last_char - cs.const(125))
    checks.append(cs.lc(is_zero(cs, cs.lc(prod))))

    ok = b_or(cs, multi_and(cs, checks), skip_checks)
    cs.constrain_eq(ok, cs.const(1))


def _whitespace_checks(cs, field, selectors) -> LinComb:
    ws = [is_whitespace(cs, ch) for ch in field]
    checks = []
    for i in range(len(field)):
        sel_sum = LinComb()
        for s in selectors:
            sel_sum = sel_sum + s[i]
        v = cs.lc(cs.mul(sel_sum, b_not(cs, ws[i])))
        checks.append(cs.lc(is_zero(cs, v)))
    return multi_and(cs, checks)


def parse_jwt_field_quoted(
    cs,
    field,
    name,
    value,
    field_string_bodies,
    field_len,
    name_len,
    value_index,
    value_len,
    colon_index,
    skip_checks,
) -> None:
    """ParseJWTFieldWithQuotedValue.circom:25-77."""
    parse_jwt_field_shared(
        cs, field, name, value, field_len, name_len, value_index, value_len, colon_index, skip_checks
    )
    n = len(field)
    checks = []
    q1 = select_array_value(cs, field, value_index - cs.const(1))
    checks.append(cs.lc(is_equal(cs, q1, cs.const(34))))
    q2 = select_array_value(cs, field, value_index + value_len)
    checks.append(cs.lc(is_equal(cs, q2, cs.const(34))))

    ws1 = array_selector_complex(cs, name_len + cs.const(2), colon_index, n)
    ws2 = array_selector_complex(cs, colon_index + cs.const(1), value_index - cs.const(1), n)
    ws3 = array_selector_complex(cs, value_index + value_len + cs.const(1), field_len - cs.const(1), n)
    name_sel = array_selector(cs, cs.const(1), name_len + cs.const(1), n)
    value_sel = array_selector(cs, value_index, value_index + value_len, n)

    ws = [is_whitespace(cs, ch) for ch in field]
    sub_checks = []
    for i in range(n):
        sel_sum = ws1[i] + ws2[i] + ws3[i]
        sub_checks.append(cs.lc(is_zero(cs, cs.lc(cs.mul(sel_sum, b_not(cs, ws[i]))))))
        nv = cs.lc(name_sel[i]) + cs.lc(value_sel[i])
        sub_checks.append(
            cs.lc(is_zero(cs, cs.lc(cs.mul(nv, b_not(cs, field_string_bodies[i])))))
        )
        sub_checks.append(
            cs.lc(is_zero(cs, cs.lc(cs.mul(b_not(cs, nv), field_string_bodies[i]))))
        )
    checks.append(multi_and(cs, sub_checks))
    ok = b_or(cs, multi_and(cs, checks), skip_checks)
    cs.constrain_eq(ok, cs.const(1))


def parse_jwt_field_unquoted(
    cs, field, name, value, field_len, name_len, value_index, value_len, colon_index, skip_checks
) -> None:
    """ParseJWTFieldWithUnquotedValue.circom:24-67."""
    parse_jwt_field_shared(
        cs, field, name, value, field_len, name_len, value_index, value_len, colon_index, skip_checks
    )
    n = len(field)
    ws1 = array_selector_complex(cs, name_len + cs.const(2), colon_index, n)
    ws2 = array_selector_complex(cs, colon_index + cs.const(1), value_index, n)
    ws3 = array_selector_complex(cs, value_index + value_len, field_len - cs.const(1), n)
    c0 = _whitespace_checks(cs, field, [ws1, ws2, ws3])

    value_sel = array_selector(cs, value_index, value_index + value_len, n)
    sub = []
    for i, ch in enumerate(field):
        bad = (
            cs.lc(is_equal(cs, ch, cs.const(44)))
            + cs.lc(is_equal(cs, ch, cs.const(125)))
            + cs.lc(is_equal(cs, ch, cs.const(34)))
        )
        sub.append(cs.lc(is_zero(cs, cs.lc(cs.mul(cs.lc(value_sel[i]), bad)))))
    c1 = multi_and(cs, sub)
    ok = b_or(cs, b_and(cs, c0, c1), skip_checks)
    cs.constrain_eq(ok, cs.const(1))


def parse_email_verified_field(
    cs, field, name, value, field_len, name_len, value_index, value_len, colon_index
) -> None:
    """ParseEmailVerifiedField.circom:26-86 (value may or may not be quoted)."""
    parse_jwt_field_shared(
        cs, field, name, value, field_len, name_len, value_index, value_len, colon_index, LinComb()
    )
    n = len(field)
    before = select_array_value(cs, field, value_index - cs.const(1))
    b_q = cs.lc(is_equal(cs, before, cs.const(34)))
    b_ws = is_whitespace(cs, before)
    b_qws = b_or(cs, b_q, b_ws)
    cs.constrain(
        b_not(cs, b_qws), value_index - cs.const(1) - colon_index, LinComb()
    )
    after = select_array_value(cs, field, value_index + value_len)
    a_q = cs.lc(is_equal(cs, after, cs.const(34)))
    a_ws = is_whitespace(cs, after)
    a_qws = b_or(cs, a_q, a_ws)
    cs.constrain(
        b_not(cs, a_qws), field_len - cs.const(1) - value_index - value_len, LinComb()
    )
    # no mismatched quotes
    cs.constrain_zero(b_and(cs, b_q, a_ws) + b_and(cs, b_ws, a_q))

    ws1 = array_selector_complex(cs, name_len + cs.const(2), colon_index, n)
    ws2 = array_selector_complex(cs, colon_index + cs.const(1), value_index - cs.const(1), n)
    ws3 = array_selector_complex(cs, value_index + value_len + cs.const(1), field_len - cs.const(1), n)
    ws = [is_whitespace(cs, ch) for ch in field]
    for i in range(n):
        cs.constrain(ws1[i] + ws2[i] + ws3[i], b_not(cs, ws[i]), LinComb())


def email_verified_check(
    cs,
    ev_name: list[LinComb],
    ev_value: list[LinComb],
    ev_value_len: LinComb,
    uid_name: list[LinComb],
    uid_name_len: LinComb,
) -> LinComb:
    """EmailVerifiedCheck.circom:10-57; returns uid_is_email (binary)."""
    email = b"email"
    starts = [
        cs.lc(is_equal(cs, uid_name[i], cs.const(email[i]))) for i in range(5)
    ]
    starts_with = multi_and(cs, starts)
    len5 = cs.lc(is_equal(cs, uid_name_len, cs.const(5)))
    uid_is_email = b_and(cs, starts_with, len5)

    required = b"email_verified"
    for i in range(14):
        # ConditionallyAssertEqual: uid_is_email * (ev_name[i] - req) == 0
        cs.constrain(uid_is_email, ev_name[i] - cs.const(required[i]), LinComb())

    len4 = cs.lc(is_equal(cs, ev_value_len, cs.const(4)))
    len6 = cs.lc(is_equal(cs, ev_value_len, cs.const(6)))
    len_ok = b_or(cs, len4, len6)
    ok = b_or(cs, b_not(cs, uid_is_email), len_ok)
    cs.constrain_eq(ok, cs.const(1))

    check4 = b_and(cs, len4, uid_is_email)
    for i, c in enumerate(b"true"):
        cs.constrain(check4, ev_value[i] - cs.const(c), LinComb())
    check6 = b_and(cs, len6, uid_is_email)
    for i, c in enumerate(b'"true"'):
        cs.constrain(check6, ev_value[i] - cs.const(c), LinComb())
    return uid_is_email
