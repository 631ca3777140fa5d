"""Dataset preprocessing CLI: raw ratings -> tmp/<dataset>/sasrec_format.csv.

Counterpart of `rails_tpu/cli/preprocess.py`, on the port's pandas-free
preprocessors (`data/preprocessor.py`). A dataset whose raw files are
missing under `--root` is downloaded first, which needs network access.

Usage: python3 -m rails_tpu_torch.cli.preprocess [--datasets ml-1m ml-20m amzn-books]
"""

from __future__ import annotations

import argparse
import logging
import sys

from rails_tpu_torch.data.preprocessor import get_common_preprocessors


def main(argv=None) -> None:
    logging.basicConfig(stream=sys.stdout, level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--datasets", nargs="+", default=["ml-1m", "ml-20m", "amzn-books"])
    p.add_argument("--root", default=".")
    args = p.parse_args(argv)
    pre = get_common_preprocessors(args.root)
    for name in args.datasets:
        logging.info("preprocessing %s ...", name)
        n = pre[name].preprocess_rating()
        logging.info("%s: %d unique items -> %s", name, n, pre[name].output_format_csv())


if __name__ == "__main__":
    main()
