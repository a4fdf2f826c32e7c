"""Host-side utilities (counterpart of thr3ed_atom_tpu/utils/misc.py): the
stage plan of the coarse-to-fine trainer, the run configuration on disk, the
power-of-2 check and the host-side chunked map ``batchify``.

``log_config_to_disk`` writes ``config.yml`` with a few-line emitter for the
flat configuration dict (scalars, paths and sequences of scalars), so the port
needs no YAML package; ``yaml.safe_load`` reads the file back to the same dict
with sequences as lists.
"""
import json
import math
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple

import numpy as np

# the JAX package keeps it in rendering/rays.py, as the port does
from thr3ed_atom_tpu_torch.rendering.rays import (  # noqa: F401
    compute_expected_density_scale_for_relu_field_grid,
)
from thr3ed_atom_tpu_torch.utils.logging import log


def check_power_of_2(x: int) -> bool:
    return x != 0 and (x & (x - 1)) == 0


def batchify(processor_fn, collate_fn, chunk_size, verbose: bool = False):
    """Host-side chunked map: ``x`` in chunks of ``chunk_size`` through
    ``processor_fn``, the results through ``collate_fn`` (one call of
    ``processor_fn`` when ``chunk_size`` is None or ``x`` fits one chunk).
    ``verbose`` logs each chunk's progress."""

    def batchified(x):
        if chunk_size is None or len(x) <= chunk_size:
            return processor_fn(x)
        starts = range(0, len(x), chunk_size)
        results = []
        for n, i in enumerate(starts):
            if verbose:
                log.info(f"batchify: chunk {n + 1} / {len(starts)}")
            results.append(processor_fn(x[i: i + chunk_size]))
        return collate_fn(results)

    return batchified


def compute_thre3d_grid_sizes(
    final_required_resolution: Tuple[int, int, int],
    num_stages: int,
    scale_factor: float,
) -> Sequence[Tuple[int, int, int]]:
    """Stagewise grid resolutions: repeatedly ceil-divide the final resolution by
    ``scale_factor``, so e.g. 256^3 over 4 stages x2 gives [32^3, 64^3, 128^3, 256^3]."""
    x, y, z = final_required_resolution
    grid_sizes = [(x, y, z)]
    for _ in range(num_stages - 1):
        x = int(np.ceil((1 / scale_factor) * x))
        y = int(np.ceil((1 / scale_factor) * y))
        z = int(np.ceil((1 / scale_factor) * z))
        grid_sizes.insert(0, (x, y, z))
    return grid_sizes


def _yaml_scalar(value: Any) -> str:
    """One YAML scalar that a YAML 1.1 loader reads back as ``value``."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, _, exponent = text.partition("e")
        if "." not in mantissa:  # YAML 1.1 reads a float only with a point
            mantissa += ".0"
        if exponent and exponent[0] not in "+-":
            exponent = "+" + exponent
        return mantissa + ("e" + exponent if exponent else "")
    # a JSON string is a YAML double-quoted scalar
    return json.dumps(str(value))


def log_config_to_disk(args: Dict[str, Any], output_dir: Path,
                       config_name: str = "config") -> None:
    """Dump the run configuration as YAML for reproducibility, keys sorted:
    ``key: scalar`` or a block sequence of scalars."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    config_file = output_dir / f"{config_name}.yml"
    log.info(f"Logging configuration file at: {config_file}")
    lines = []
    for key in sorted(args):
        value = args[key]
        if isinstance(value, (list, tuple)):
            lines.append(f"{key}:" if value else f"{key}: []")
            lines.extend(f"- {_yaml_scalar(v)}" for v in value)
        else:
            lines.append(f"{key}: {_yaml_scalar(value)}")
    config_file.write_text("\n".join(lines) + "\n")
