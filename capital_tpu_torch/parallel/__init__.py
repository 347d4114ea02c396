"""Distributed layer; one device in this slice (summa.py)."""
