"""Index-build configuration: the port's copy of ``veloci_tpu/config.py``
(features, per-field config, fulltext options).

Mirrors the reference's three-level config model:

* ``Features`` — user-facing capability flags that resolve to the 9 concrete
  index types (reference: src/create/features.rs:4-94).
* ``FieldConfig`` / ``FieldsConfig`` — per-field-path settings with a
  ``*GLOBAL*`` fallback, parsed from TOML or JSON
  (reference: src/create/fields_config.rs).
* ``FulltextIndexOptions`` — tokenization options per field
  (reference: src/metadata.rs:45-106).
"""

from __future__ import annotations

import json
import tomllib
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Set

from .error import VelociError
from .tokenizer import GroupTokenizer, Tokenizer

__all__ = [
    "Features",
    "IndexCreationType",
    "FulltextIndexOptions",
    "BoostIndexOptions",
    "FieldConfig",
    "FieldsConfig",
    "config_from_string",
    "ALL_FIELD_CONFIG",
]

ALL_FIELD_CONFIG = "*GLOBAL*"


class Features:
    """Feature flags (reference src/create/features.rs:4-16)."""

    All = "All"
    TokensToTextID = "TokensToTextID"
    BoostTextLocality = "BoostTextLocality"
    BoostingFieldData = "BoostingFieldData"
    Search = "Search"
    Filters = "Filters"
    Facets = "Facets"
    Select = "Select"
    WhyFound = "WhyFound"
    Highlight = "Highlight"
    PhraseBoost = "PhraseBoost"

    ALL_CONCRETE = (
        TokensToTextID,
        BoostTextLocality,
        BoostingFieldData,
        Search,
        Filters,
        Facets,
        Select,
        WhyFound,
        Highlight,
        PhraseBoost,
    )

    @staticmethod
    def default_features() -> Set[str]:
        # Reference features.rs:19-21
        return {Features.Search, Features.TokensToTextID}

    @staticmethod
    def invert(features: Set[str]) -> Set[str]:
        # Reference features.rs:23-38: all concrete features NOT in the set...
        # (NB the reference's filter keeps features *contained*; the intent and
        # use is disabled_features -> enabled = complement)
        return {f for f in Features.ALL_CONCRETE if f not in features}

    @staticmethod
    def features_to_disabled_indices(features: Set[str]) -> Set[str]:
        """Resolve feature set -> disabled index types (features.rs:41-80)."""
        disabled: Set[str] = set()

        def disable_unless(needed: Sequence[str], index_type: str) -> None:
            if not any(f in features for f in needed):
                disabled.add(index_type)

        F, I = Features, IndexCreationType
        disable_unless(
            [F.All, F.TokensToTextID, F.BoostTextLocality, F.Highlight, F.BoostingFieldData],
            I.TokensToTextID,
        )
        disable_unless([F.All, F.Search], I.TokenToAnchorIDScore)
        disable_unless([F.All, F.Select, F.Facets], I.ParentToValueID)
        disable_unless([F.All, F.BoostingFieldData], I.ValueIDToParent)
        disable_unless([F.All, F.PhraseBoost], I.PhrasePairToAnchor)
        disable_unless([F.All, F.Select, F.WhyFound], I.TextIDToTokenIds)
        disable_unless([F.All, F.BoostingFieldData], I.TextIDToParent)
        disable_unless([F.All, F.Facets, F.Select], I.ParentToTextID)
        disable_unless(
            [F.All, F.BoostTextLocality, F.Select, F.Filters], I.TextIDToAnchor
        )
        return disabled


class IndexCreationType:
    """The 9 concrete per-field index types (features.rs:84-94)."""

    TokensToTextID = "TokensToTextID"
    TokenToAnchorIDScore = "TokenToAnchorIDScore"
    PhrasePairToAnchor = "PhrasePairToAnchor"
    TextIDToTokenIds = "TextIDToTokenIds"
    TextIDToParent = "TextIDToParent"
    ParentToTextID = "ParentToTextID"
    ParentToValueID = "ParentToValueID"
    ValueIDToParent = "ValueIDToParent"
    TextIDToAnchor = "TextIDToAnchor"


DEFAULT_TEXT_LENGTH_STORE = 64  # reference metadata.rs:66-68


@dataclass
class FulltextIndexOptions:
    """Reference: src/metadata.rs:45-106 (`FulltextIndexOptions`)."""

    tokenize: bool = True
    tokenize_on_chars: Optional[Sequence[str]] = None
    stopwords: Optional[Set[str]] = None
    do_not_store_text_longer_than: int = DEFAULT_TEXT_LENGTH_STORE
    _tokenizer: Optional[Tokenizer] = field(default=None, repr=False, compare=False)

    @property
    def tokenizer(self) -> Optional[Tokenizer]:
        if self._tokenizer is None and self.tokenize:
            if self.tokenize_on_chars is not None:
                self._tokenizer = GroupTokenizer(self.tokenize_on_chars)
            else:
                self._tokenizer = GroupTokenizer()
        return self._tokenizer

    @classmethod
    def from_dict(cls, d: dict) -> "FulltextIndexOptions":
        return cls(
            tokenize=d.get("tokenize", True),
            tokenize_on_chars=d.get("tokenize_on_chars"),
            stopwords=set(d["stopwords"]) if d.get("stopwords") else None,
            do_not_store_text_longer_than=d.get(
                "do_not_store_text_longer_than", DEFAULT_TEXT_LENGTH_STORE
            ),
        )

    def to_dict(self) -> dict:
        out: dict = {
            "tokenize": self.tokenize,
            "do_not_store_text_longer_than": self.do_not_store_text_longer_than,
        }
        if self.tokenize_on_chars is not None:
            out["tokenize_on_chars"] = list(self.tokenize_on_chars)
        if self.stopwords is not None:
            out["stopwords"] = sorted(self.stopwords)
        return out


@dataclass
class BoostIndexOptions:
    """Reference: fields_config.rs:88-96 (only ``f32`` exists)."""

    boost_type: str = "f32"


@dataclass
class FieldConfig:
    """Per-field config (reference fields_config.rs:57-86)."""

    facet: bool = False
    fulltext: Optional[FulltextIndexOptions] = None
    disabled_indices: Optional[Set[str]] = None
    features: Optional[Set[str]] = None
    disabled_features: Optional[Set[str]] = None
    boost: Optional[BoostIndexOptions] = None

    @classmethod
    def default(cls) -> "FieldConfig":
        return cls(
            facet=False,
            features=Features.default_features(),
            fulltext=FulltextIndexOptions(),
        )

    def is_index_enabled(self, index_type: str) -> bool:
        if self.disabled_indices is None:
            return True
        return index_type not in self.disabled_indices

    @classmethod
    def from_dict(cls, d: dict) -> "FieldConfig":
        fulltext = d.get("fulltext")
        boost = d.get("boost")
        return cls(
            facet=d.get("facet", False),
            fulltext=FulltextIndexOptions.from_dict(fulltext) if fulltext else None,
            disabled_indices=set(d["disabled_indices"]) if d.get("disabled_indices") else None,
            features=set(d["features"]) if d.get("features") else None,
            disabled_features=set(d["disabled_features"]) if d.get("disabled_features") else None,
            boost=BoostIndexOptions(boost.get("boost_type", "f32")) if boost else None,
        )


class FieldsConfig:
    """Path -> FieldConfig map with ``*GLOBAL*`` fallback (fields_config.rs:18-55)."""

    def __init__(self, configs: Dict[str, FieldConfig]):
        self.configs = configs

    def get(self, path: str) -> FieldConfig:
        if path.endswith(".textindex"):
            path = path[: -len(".textindex")]
        cfg = self.configs.get(path)
        if cfg is not None:
            return cfg
        return self.configs[ALL_FIELD_CONFIG]

    def features_to_indices(self) -> None:
        """Resolve features -> disabled_indices (fields_config.rs:33-55)."""
        if ALL_FIELD_CONFIG not in self.configs:
            self.configs[ALL_FIELD_CONFIG] = FieldConfig.default()
        for key, cfg in self.configs.items():
            if cfg.features is not None and cfg.disabled_features is not None:
                raise VelociError(
                    f"features and disabled_features are not allowed at the same "
                    f"time in field {key!r}"
                )
            features = cfg.features
            if features is None and cfg.disabled_features is not None:
                features = Features.invert(cfg.disabled_features)
            if features is not None:
                disabled = Features.features_to_disabled_indices(features)
                existing = set(cfg.disabled_indices or ())
                existing.update(disabled)
                cfg.disabled_indices = existing


def config_from_string(indices: str) -> FieldsConfig:
    """Parse TOML or JSON config (reference fields_config.rs:98-110). TOML
    ``["meanings.ger[]".fulltext]`` parses to ``{"meanings.ger[]":
    {"fulltext": {...}}}``: keys are the quoted field paths."""
    indices = indices or "{}"
    if indices.strip().startswith("{"):
        raw = json.loads(indices)
    else:
        raw = tomllib.loads(indices)
    configs = {key: FieldConfig.from_dict(val) for key, val in raw.items()}
    return FieldsConfig(configs)
