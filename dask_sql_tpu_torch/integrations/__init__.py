"""Optional integrations: the IPython ``%%sql`` magic (``ipython.py``) and
the fugue SQL engine (``fugue.py``); each imports its package only when
used."""
