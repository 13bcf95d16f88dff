"""The plain NumPy reference of the benchmark's searches.

It works veloci's semantics out again from the corpus text and the request
JSON, independently of the program under test: the tokenizer
(:mod:`.tokenizer`, a frozen copy of the separator rule), the index-time
term scores, the dictionary of each field (texts and tokens), the
Levenshtein distance as a plain dynamic programme (:mod:`.levenshtein`),
and the set semantics of OR and AND with veloci's union weighting
(:mod:`.search`). It imports nothing of the program, JAX or the JAX package.
"""
