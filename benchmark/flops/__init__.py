"""Operations and bytes counted from shapes: `transformer.py` the shared
counts, `<config>.py` a configuration's step and sweep, `attention.py` the
attention kernel's least time, `peaks.json` the card's published peaks."""
