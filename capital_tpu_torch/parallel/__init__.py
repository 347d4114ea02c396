"""Distributed layer: the launcher (launch.py), the collectives on mesh
axes (collectives.py), distributed arrays (darray.py), the 2.5D SUMMA
engines (summa.py) and block-cyclic windows (cyclic.py, one device)."""
