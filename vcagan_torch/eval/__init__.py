"""Metrics: STOI/ESTOI on the device, and the numpy STOI and PESQ."""
