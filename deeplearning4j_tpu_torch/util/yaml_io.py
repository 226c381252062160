"""JSON <-> YAML bridging for configuration serialization.

Counterpart of ``deeplearning4j_tpu/util/yaml_io.py``: a configuration
goes through its canonical JSON form and is rendered as block-style
YAML. ``yaml`` is imported only when one of these is called.
"""

from __future__ import annotations

import json


def json_to_yaml(json_str: str) -> str:
    import yaml
    return yaml.safe_dump(json.loads(json_str), sort_keys=False)


def yaml_to_json(yaml_str: str) -> str:
    import yaml
    return json.dumps(yaml.safe_load(yaml_str))
