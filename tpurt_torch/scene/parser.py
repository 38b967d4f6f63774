"""Recursive-descent parser for pbrt scene files.

Reference analog: core/parser.cpp parse() (:786-1090) — a loop over
directives dispatching into the scene API (tpurt.scene.api), with Include
handled by a tokenizer stack.  Directive set matches the reference's
grammar exactly (39 directives + parameter lists).
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

from tpurt_torch.scene.tokenizer import Token, Tokenizer
from tpurt_torch.scene.paramset import ParamSet


class ParseError(Exception):
    pass


def _atom_value(tok: Token) -> Any:
    """Numbers stay strings until typed by the ParamSet; booleans in
    parameter lists arrive as the atoms true/false."""
    return tok.value


class _TokenStream:
    """Tokenizer stack for Include files (parser.cpp includeStack)."""

    def __init__(self, root: Tokenizer):
        self.stack = [root]

    def peek(self) -> Optional[Token]:
        while self.stack:
            t = self.stack[-1].peek()
            if t is not None:
                return t
            self.stack.pop()
        return None

    def next(self) -> Optional[Token]:
        t = self.peek()
        if t is not None:
            self.stack[-1].next()
        return t

    def push_include(self, path: str) -> None:
        self.stack.append(Tokenizer.from_file(path))


class Parser:
    def __init__(self, api, base_dir: str = "."):
        self.api = api
        self.base_dir = base_dir

    # -- low-level helpers ----------------------------------------------------
    def _expect(self, ts: _TokenStream, what: str) -> Token:
        t = ts.next()
        if t is None:
            raise ParseError(f"premature end of file; expected {what}")
        return t

    def _string(self, ts: _TokenStream) -> str:
        t = self._expect(ts, "a string")
        if t.kind != "string":
            raise ParseError(f"{t.loc}: expected a string, got {t.value!r}")
        return t.value

    def _float(self, ts: _TokenStream) -> float:
        t = self._expect(ts, "a number")
        if t.kind == "open":  # numbers may be bracketed, e.g. Transform [ ... ]
            v = float(self._float(ts))
            return v
        try:
            return float(t.value)
        except ValueError:
            raise ParseError(f"{t.loc}: expected a number, got {t.value!r}")

    def _floats(self, ts: _TokenStream, n: int) -> List[float]:
        # pbrt allows the whole group to be bracketed (e.g. Transform [m..]).
        out: List[float] = []
        bracketed = False
        t = ts.peek()
        if t is not None and t.kind == "open":
            ts.next()
            bracketed = True
        for _ in range(n):
            tok = self._expect(ts, "a number")
            if tok.kind != "atom":
                raise ParseError(f"{tok.loc}: expected a number, got {tok.value!r}")
            out.append(float(tok.value))
        if bracketed:
            tok = self._expect(ts, "']'")
            if tok.kind != "close":
                raise ParseError(f"{tok.loc}: expected ']'")
        return out

    def _param_list(self, ts: _TokenStream) -> ParamSet:
        """Read '"type name" value-or-[values]' pairs until the next token is
        not a string (parser.cpp parseParams)."""
        items: List[Tuple[str, List[Any]]] = []
        while True:
            t = ts.peek()
            if t is None or t.kind != "string":
                break
            decl = ts.next().value
            values: List[Any] = []
            t = ts.peek()
            if t is not None and t.kind == "open":
                ts.next()
                while True:
                    t = self._expect(ts, "']'")
                    if t.kind == "close":
                        break
                    values.append(_atom_value(t))
            else:
                t = self._expect(ts, "a parameter value")
                values.append(_atom_value(t))
            items.append((decl, values))
        return ParamSet.from_parsed(items, base_dir=self.base_dir)

    # -- main loop --------------------------------------------------------------
    def parse(self, ts: _TokenStream) -> None:
        api = self.api
        while True:
            tok = ts.next()
            if tok is None:
                break
            if tok.kind != "atom":
                raise ParseError(f"{tok.loc}: unexpected token {tok.value!r}")
            d = tok.value

            if d == "AttributeBegin":
                api.attribute_begin()
            elif d == "AttributeEnd":
                api.attribute_end()
            elif d == "ActiveTransform":
                which = self._expect(ts, "All|StartTime|EndTime").value
                api.active_transform(which)
            elif d == "AreaLightSource":
                api.area_light_source(self._string(ts), self._param_list(ts))
            elif d == "Accelerator":
                api.accelerator(self._string(ts), self._param_list(ts))
            elif d == "ConcatTransform":
                api.concat_transform(self._floats(ts, 16))
            elif d == "CoordinateSystem":
                api.coordinate_system(self._string(ts))
            elif d == "CoordSysTransform":
                api.coord_sys_transform(self._string(ts))
            elif d == "Camera":
                api.camera(self._string(ts), self._param_list(ts))
            elif d == "Film":
                api.film(self._string(ts), self._param_list(ts))
            elif d == "Integrator":
                api.integrator(self._string(ts), self._param_list(ts))
            elif d == "Include":
                path = self._string(ts)
                if not os.path.isabs(path):
                    path = os.path.join(self.base_dir, path)
                ts.push_include(path)
            elif d == "Identity":
                api.identity()
            elif d == "LightSource":
                api.light_source(self._string(ts), self._param_list(ts))
            elif d == "LookAt":
                v = self._floats(ts, 9)
                api.look_at(v[0:3], v[3:6], v[6:9])
            elif d == "MakeNamedMaterial":
                api.make_named_material(self._string(ts), self._param_list(ts))
            elif d == "MakeNamedMedium":
                api.make_named_medium(self._string(ts), self._param_list(ts))
            elif d == "Material":
                api.material(self._string(ts), self._param_list(ts))
            elif d == "MediumInterface":
                inside = self._string(ts)
                outside = ""
                t = ts.peek()
                if t is not None and t.kind == "string":
                    outside = ts.next().value
                api.medium_interface(inside, outside)
            elif d == "NamedMaterial":
                api.named_material(self._string(ts))
            elif d == "ObjectBegin":
                api.object_begin(self._string(ts))
            elif d == "ObjectEnd":
                api.object_end()
            elif d == "ObjectInstance":
                api.object_instance(self._string(ts))
            elif d == "PixelFilter":
                api.pixel_filter(self._string(ts), self._param_list(ts))
            elif d == "ReverseOrientation":
                api.reverse_orientation()
            elif d == "Rotate":
                v = self._floats(ts, 4)
                api.rotate(v[0], v[1:4])
            elif d == "Shape":
                api.shape(self._string(ts), self._param_list(ts))
            elif d == "Sampler":
                api.sampler(self._string(ts), self._param_list(ts))
            elif d == "Scale":
                v = self._floats(ts, 3)
                api.scale(*v)
            elif d == "TransformBegin":
                api.transform_begin()
            elif d == "TransformEnd":
                api.transform_end()
            elif d == "Transform":
                api.set_transform(self._floats(ts, 16))
            elif d == "Translate":
                v = self._floats(ts, 3)
                api.translate(*v)
            elif d == "TransformTimes":
                v = self._floats(ts, 2)
                api.transform_times(v[0], v[1])
            elif d == "Texture":
                name = self._string(ts)
                typ = self._string(ts)
                texname = self._string(ts)
                api.texture(name, typ, texname, self._param_list(ts))
            elif d == "WorldBegin":
                api.world_begin()
            elif d == "WorldEnd":
                api.world_end()
            else:
                raise ParseError(f"{tok.loc}: unknown directive {d!r}")


def parse_file(path: str, api) -> None:
    """pbrtParseFile analog (parser.cpp:1094)."""
    base = os.path.dirname(os.path.abspath(path))
    p = Parser(api, base_dir=base)
    if path == "-":
        import sys

        ts = _TokenStream(Tokenizer(sys.stdin.read(), "<stdin>"))
    else:
        ts = _TokenStream(Tokenizer.from_file(path))
    p.parse(ts)


def parse_string(text: str, api, base_dir: str = ".") -> None:
    """pbrtParseString analog (parser.cpp:1104)."""
    p = Parser(api, base_dir=base_dir)
    p.parse(_TokenStream(Tokenizer(text, "<string>")))
