"""Segmentation drivers."""
