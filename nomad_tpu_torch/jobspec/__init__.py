"""Jobspec language: HCL2-subset parser producing Job dataclasses
(ref jobspec2/parse.go:19, jobspec/parse.go)."""
from .hcl import HCLError, parse as parse_hcl
from .parse import ParseError, duration, parse, parse_file

__all__ = ["HCLError", "ParseError", "duration", "parse", "parse_file",
           "parse_hcl"]
