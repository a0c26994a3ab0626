"""Builders of the program's operators, one file per `operator.kind` of a
configuration file."""

import importlib


def module(spec):
    return importlib.import_module(f"cardbench.systems.{spec['kind']}")
