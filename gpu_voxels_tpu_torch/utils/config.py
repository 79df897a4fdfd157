"""Config / flag system (reference: icl_core_config).

Counterpart of gpu_voxels_tpu/utils/config.py (the same code).

The reference layers a Getopt CLI singleton over XML AttributeTree config
files with typed batch getters and observers (Config.h:387-473). Here:

  * ConfigManager: '/'-separated attribute tree with typed get/set,
    load from XML (the reference's file format) or TOML-like dicts,
    observer callbacks per subtree.
  * add_parameters/parse: argparse-backed CLI that writes into the tree,
    mirroring Getopt-into-ConfigManager.
"""
from __future__ import annotations

import argparse
import xml.etree.ElementTree as ET
from typing import Any, Callable, Dict, List, Optional


class ConfigManager:
    _instance: Optional["ConfigManager"] = None

    def __init__(self):
        self._values: Dict[str, str] = {}
        self._observers: List[tuple] = []
        self._parser = argparse.ArgumentParser(add_help=False)
        self._cli_dests: Dict[str, str] = {}

    @classmethod
    def instance(cls) -> "ConfigManager":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # -- tree ------------------------------------------------------------
    def set(self, key: str, value: Any) -> None:
        self._values[key] = str(value)
        for prefix, cb in self._observers:
            if key.startswith(prefix):
                cb(key, value)

    def get(self, key: str, type_: Callable = str, default: Any = None) -> Any:
        if key not in self._values:
            return default
        v = self._values[key]
        if type_ is bool:
            return v.lower() in ("1", "true", "yes", "on")
        return type_(v)

    def get_batch(self, entries) -> Dict[str, Any]:
        """Typed batch getter: [(key, type, default), ...] -> dict."""
        return {k: self.get(k, t, d) for k, t, d in entries}

    def has(self, key: str) -> bool:
        return key in self._values

    def keys(self, prefix: str = "") -> List[str]:
        return [k for k in self._values if k.startswith(prefix)]

    def observe(self, prefix: str, callback: Callable[[str, Any], None]) -> None:
        """ConfigObserver equivalent."""
        self._observers.append((prefix, callback))

    # -- XML attribute trees ---------------------------------------------
    def load_xml(self, path) -> None:
        """Load the reference's XML config format: nested elements become
        '/'-separated keys with element text as value."""
        root = ET.parse(path).getroot()

        def walk(el, prefix):
            children = list(el)
            if not children:
                if el.text is not None and el.text.strip():
                    self.set(f"{prefix}/{el.tag}" if prefix else f"/{el.tag}", el.text.strip())
                return
            base = f"{prefix}/{el.tag}" if prefix else f"/{el.tag}"
            for c in children:
                walk(c, base)

        for c in list(root):
            walk(c, f"/{root.tag}")

    # -- CLI (Getopt equivalent) -------------------------------------------
    def add_parameter(self, option: str, key: str, help: str = "", type_: Callable = str, default=None) -> None:
        dest = option.lstrip("-").replace("-", "_")
        self._parser.add_argument(option, dest=dest, type=type_, default=default, help=help)
        self._cli_dests[dest] = key

    def parse(self, argv=None) -> None:
        ns, _ = self._parser.parse_known_args(argv)
        for dest, key in self._cli_dests.items():
            val = getattr(ns, dest, None)
            if val is not None:
                self.set(key, val)


def initialize(argv=None) -> ConfigManager:
    """icl_core::config::initialize equivalent."""
    cm = ConfigManager.instance()
    cm.parse(argv)
    return cm
