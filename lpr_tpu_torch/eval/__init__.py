"""Evaluation: OCR accuracy and CER with and without LPSR, detection
metrics and their plots."""
