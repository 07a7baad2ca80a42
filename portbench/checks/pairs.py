"""The paired mixes' check: reference.check_pairs, whose numbers are
bad_records, bad_alignment, bad_mate, score_miss_pct and proper_miss."""

from harness import reference


def check(sample, truth, codes, contig: str, scoring: dict,
          traffic: dict) -> dict:
    return reference.check_pairs(sample, truth, codes, scoring, contig,
                                 traffic["insert_mean"], traffic["insert_sd"])
