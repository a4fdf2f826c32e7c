"""Framework-wide logger (counterpart of thr3ed_atom_tpu/utils/logging.py)."""
import logging

logging.basicConfig(format="%(asctime)s | %(message)s", level=logging.INFO)

log = logging
