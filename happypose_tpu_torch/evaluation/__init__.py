"""Evaluation: pose-error meters (ADD, ADD-S, AUC) and BOP19 scoring."""
