from .metrics import EditOps, align, corpus_wer, edit_ops, wer

__all__ = ["EditOps", "align", "corpus_wer", "edit_ops", "wer"]
