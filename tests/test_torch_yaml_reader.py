"""The port's YAML reader (`utils.io.yaml_loads`) against `yaml.safe_load`
on what scene and config files use beyond plain collections: anchors and
aliases in block and flow context (an anchor before an implicit key names
the key), the '<<' merge key (one mapping, a list of them, explicit keys
winning), and literal and folded block scalars with every chomping
indicator, an indentation indicator, leading blank lines, more-indented
lines and a last line without its line break; a tag or an unknown alias
still raises ValueError.
"""

import pytest
import torch
import yaml

from fireflies_tpu_torch.utils.io import yaml_loads

torch.set_num_threads(1)

DOCS = [
    "- &a x: 1\n  y: 2\n- *a\n",
    "a: &b\n  x: 1\nc: *b\nd:\n  <<: *b\n  z: 3\n",
    "base: &base {x: 1, y: [1, 2]}\nother: &o\n  y: 5\n  w: 6\nm:\n  <<: [*o, *base]\n  z: 0\n"
    "n: {<<: *base, x: 9}\nl: [&v 3, *v]\ns:\n  - &item\n    k: v\n  - *item\n  - &sc plain\n"
    "  - *sc\nk: &anc\n- 1\n- 2\nj: *anc\n",
    "a: |\n  x\n\n  y\n   z\nb: >\n  p\n  q\n\n  r\n   s\n  t\nc: |-\n  k\n\n\nd: |+\n  k\n\n\n"
    "e: >2\n   lead\n  n\nf: x\n",
    "a:\n  b: |  # a comment after the header\n    line one\n      indented # not a comment\n"
    "    line three\n  c: 1\nlast: >-\n  folded\n  text\n\n  para\n",
    "- |\n  seq lit\n- >+\n  keep\n\n- x\n",
    "x: >\n\n  leading blank\n  more\ntop: |2\n    two extra\n  base\n",
    "q: |\n  no final newline",
]


def test_yaml_loads_matches_safe_load():
    for doc in DOCS:
        assert yaml_loads(doc) == yaml.safe_load(doc), doc
    for bad in ("a: !!str 1\n", "a: *nope\n", "- !tag x\n"):
        with pytest.raises(ValueError):
            yaml_loads(bad)
