"""Least-time counts and the card's published peaks."""
