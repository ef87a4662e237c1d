"""Workloads of the port run end to end (``bank_ledger``) and the
launcher's committed deployment (``loopback_3ar_3rc.properties``)."""
