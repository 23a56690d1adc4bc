"""The reference's fixed eval sentence set (hparams.py:370-395): what
`cli synthesize --mode eval` speaks when no text is given.
"""

EVAL_SENTENCES = [
    # From July 8, 2017 New York Times:
    "Scientists at the CERN laboratory say they have discovered a new "
    "particle.",
    "There's a way to measure the acute emotional intelligence that has "
    "never gone out of style.",
    "President Trump met with other leaders at the Group of 20 conference.",
    "The Senate's bill to repeal and replace the Affordable Care Act is "
    "now imperiled.",
    # From Google's Tacotron example page:
    "Generative adversarial network or variational auto-encoder.",
    "Basilar membrane and otolaryngology are not auto-correlations.",
    "He has read the whole thing.",
    "He reads books.",
    "He thought it was time to present the present.",
    "Thisss isrealy awhsome.",
    "The big brown fox jumps over the lazy dog.",
    "Did the big brown fox jump over the lazy dog?",
    "Peter Piper picked a peck of pickled peppers. How many pickled "
    "peppers did Peter Piper pick?",
    "She sells sea-shells on the sea-shore. The shells she sells are "
    "sea-shells I'm sure.",
    "Tajima Airport serves Toyooka.",
    # A final Thank you note!
    "Thank you so much for your support!",
]
