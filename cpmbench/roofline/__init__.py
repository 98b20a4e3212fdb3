"""The work a kernel's inputs need, counted from shapes and inputs alone
(nothing of the program's build or exports), and the card's peaks: the
yardstick of the ``*_roofline`` metrics."""
