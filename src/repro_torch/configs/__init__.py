"""Configurations the port serves (own copies of the reference's)."""
