"""Read a dataset description (the port's stand-in for the ``yaml.safe_load``
in yolov6_tpu/core/evaler.py:507-519; the machine with the card has no
``yaml``).

``.json`` is read with ``json``. ``.yaml``/``.yml`` is read by a small parser
of the flat form the repository's ``data/*.yaml`` use: ``key: value`` lines,
``#`` comments, and inline ``[...]`` lists that may run over several lines.
Scalars follow YAML 1.1 as ``yaml.safe_load`` reads them (ints, floats,
booleans such as ``True``/``no``, ``null``/``~``, quoted and plain strings).
Anything else (nested mappings, block lists, anchors, flow mappings) raises
``ValueError``.
"""

from __future__ import annotations

import json
import re

_BOOLS = {v: True for v in ("y", "Y", "yes", "Yes", "YES", "true", "True", "TRUE",
                            "on", "On", "ON")}
_BOOLS.update({v: False for v in ("n", "N", "no", "No", "NO", "false", "False", "FALSE",
                                  "off", "Off", "OFF")})
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(\.[0-9]+|[0-9][0-9_]*(\.[0-9_]*)?)([eE][-+]?[0-9]+)?$")
_KEY = re.compile(r"([A-Za-z_][\w\-]*)\s*:(\s+|$)(.*)$")


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str, where: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] == "'":
        return tok[1:-1].replace("''", "'")
    if len(tok) >= 2 and tok[0] == tok[-1] == '"':
        return json.loads(tok)
    if (tok and tok[0] in "&*!{[|>%@`") or tok.startswith("- "):
        raise ValueError(f"{where}: {tok!r} is not a flat YAML scalar")
    if tok in _NULLS:
        return None
    if tok in _BOOLS:
        return _BOOLS[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok) and any(c.isdigit() for c in tok):
        return float(tok.replace("_", ""))
    return tok


def _split_list(body: str, where: str):
    """The items of an inline list body (between the brackets)."""
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch == ",":
            items.append(cur)
            cur = ""
        elif ch in "[]{}":
            raise ValueError(f"{where}: nested collections are not read")
        else:
            cur += ch
    if quote:
        raise ValueError(f"{where}: unterminated quote")
    if cur.strip():  # not after a trailing comma
        items.append(cur)
    return [_scalar(t, where) for t in items]


def _parse_yaml(text: str, path: str) -> dict:
    out = {}
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        where = f"{path}:{i + 1}"
        line = _strip_comment(lines[i]).rstrip()
        i += 1
        if not line.strip() or line.strip() == "---":
            continue
        if line[0] in " \t":
            raise ValueError(f"{where}: indented line; only flat 'key: value' YAML is read")
        m = _KEY.match(line)
        if not m:
            raise ValueError(f"{where}: not a 'key: value' line: {line!r}")
        key, value = m.group(1), m.group(3).strip()
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if value.startswith("["):
            body = value[1:]
            while "]" not in _strip_comment(body):
                if i >= len(lines):
                    raise ValueError(f"{where}: list of {key!r} is not closed")
                body += " " + _strip_comment(lines[i]).strip()
                i += 1
            body = _strip_comment(body).strip()
            if not body.endswith("]") or body.count("]") != 1:
                raise ValueError(f"{where}: text after the list of {key!r}")
            out[key] = _split_list(body[:-1], where)
        elif value == "":
            nxt = next((ln for ln in lines[i:] if _strip_comment(ln).strip()), "")
            if nxt[:1] in (" ", "\t", "-"):
                raise ValueError(f"{where}: {key!r} opens a block; only flat YAML is read")
            out[key] = None
        else:
            out[key] = _scalar(value, where)
    return out


def load_data_config(path: str) -> dict:
    """The dataset description at ``path`` (``.json``, or flat ``.yaml``/
    ``.yml``) as a dict."""
    with open(path, errors="ignore") as f:
        text = f.read()
    if path.endswith(".json"):
        data = json.loads(text)
    elif path.endswith((".yaml", ".yml")):
        data = _parse_yaml(text, path)
    else:
        raise ValueError(f"{path}: a dataset description must be .json, .yaml or .yml")
    if not isinstance(data, dict):
        raise ValueError(f"{path}: a dataset description must be a mapping")
    return data
